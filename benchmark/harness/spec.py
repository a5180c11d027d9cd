"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and traffic, and the metrics.  Every piece that belongs to one
of them is a file of its own under ``benchmark/``, found by that name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, parameters that
  :mod:`harness.cell`'s one generator reads;
* a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the value or
  None where the run holds nothing to read;
* a cell's correctness limits: ``limits/<workload>.json``;
* a configuration's exogenous rule (its loads, generation potentials, aux,
  task carry and fresh start): ``reference/exogenous/<kind>.py``, the kind
  its ``reference.exogenous`` names (:mod:`harness.check`).

Adding a cell or a metric adds files and entries and edits none.
"""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """``BENCHMARK.json`` and the files it names, read from ``bench_dir``."""

    def __init__(self, root=ROOT, bench_dir=BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name):
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload):
        return json.loads((self.bench_dir / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload, kind):
        """The ``end_to_end`` or ``per_layer`` entries that ``workload`` reports:
        those that list it, and those without a list whose end-to-end metric
        the cell reports."""
        e2e = {m["name"] for m in self.doc["end_to_end"] if workload in m.get("workloads", [workload])}
        out = []
        for m in self.doc[kind]:
            cells = m.get("workloads")
            if cells is not None:
                if workload in cells:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric_name):
        """The ``read`` function of ``metrics/<metric_name>.py``."""
        return load_file(self.bench_dir / "metrics" / f"{metric_name}.py",
                         f"bench_metric_{metric_name.replace('.', '_')}").read


def load_file(path, module_name):
    """The module of the file ``path``, loaded under ``module_name``."""
    if not Path(path).is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

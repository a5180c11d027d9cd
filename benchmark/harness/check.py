"""Whether the timed path's answers are right: the checked steps against the
plain float64 reference of :mod:`reference`.

Each checked step's inputs (the action, the carried SoC, time index,
termination, aux and task carry, the exogenous draw, and for the MPC
controller its carried ADMM state) and its answers (the observation, reward,
done, the new state's bus voltages, aux and task carry) are read off the
program's structures once the window has closed.  The reference works out
the answers again from the inputs alone, lanes in blocks; each number
compared is the widest gap over every checked lane of every checked step,
held against the cell's limit.

What is exogenous to the grid (the loads, the generation potentials, the
aux and the task carry, and a fresh start's rule) is the configuration's
``reference.exogenous`` kind: a rule file of its own,
``reference/exogenous/<kind>.py`` (see that package's docstring).

The first checked steps run in a row from the reset ("chained"): there the
reference carries its own controller state from the cold start, so the
program's carry and its receding-horizon shift are held to it.  At the
window's steps the reference starts from the program's carried state.
Under autoreset a step's ``done`` and reward are the step's own, while its
observation and state are those of the fresh start that replaced a done
lane.
"""

import math
from pathlib import Path

import torch

from reference import dcopf, grid

from .spec import BENCH_DIR, load_file

BLOCK = 32768


def exogenous_rule(kind, bench_dir=BENCH_DIR):
    """The module of ``reference/exogenous/<kind>.py`` under ``bench_dir``."""
    return load_file(Path(bench_dir) / "reference" / "exogenous" / f"{kind}.py", f"bench_exogenous_{kind}")


class Reference:
    """The configuration's reference network, task constants, exogenous rule
    and, for an MPC cell, its DC-OPF; the network file and the rule are read
    from ``bench_dir``."""

    def __init__(self, config, traffic, bench_dir=BENCH_DIR):
        ref = config["reference"]
        self.net, self.raw = grid.load(ref["network"], Path(bench_dir) / "reference")
        c1, c2 = ref["costs_clipping"]
        self.task = dict(delta_t=ref["delta_t"], gamma=ref["gamma"], lamb=ref["lamb"],
                         costs_clipping=(math.inf if c1 is None else c1, math.inf if c2 is None else c2))
        self.rule = exogenous_rule(ref["exogenous"], bench_dir)
        self.autoreset = traffic["autoreset"]
        self.lo, self.hi = dcopf.action_box(self.net)
        pol = traffic["policy"]
        self.lp = None
        if pol["kind"] == "mpc_perfect":
            self.lp = dcopf.DCOPF(self.net, ref["delta_t"], ref["lamb"], pol["gamma"], pol["safety_margin"],
                                  pol["planning_steps"], max_iter=pol["max_iter"])

    def profiles(self, device):
        return (torch.tensor(self.raw["load_profiles_mw"], dtype=torch.float64, device=device),
                torch.tensor(self.raw["gen_profiles_mw"], dtype=torch.float64, device=device))

    def act(self, warm, aux_in, soc_in, precision="f64"):
        """(action, the state to carry) from the carried state ``warm``, or
        from the cold start where it is None."""
        loads, gens = self.profiles(soc_in.device)
        N, base = self.lp.N, self.net.baseMVA
        if warm is None:
            warm = dcopf.cold(self.lp, soc_in.shape[0], soc_in.device)
        P_load = dcopf.perfect_forecast(loads, aux_in[:, -1], N, base)
        P_pot = dcopf.perfect_forecast(gens, aux_in[:, -1], N, base)
        a, _, state = dcopf.action(self.lp, self.net, warm, P_load, P_pot, soc_in, self.lo, self.hi, precision)
        return a, state


def observe(snap, chained, device):
    """A checked step (a :func:`harness.cell.snapshot`'s copy) as tensors on
    ``device``: its inputs and answers, in float64 but for the flags, the
    step counters and the task carry's leaves (kept in their own dtype).  A
    chained step's controller state is the reference's own, so the program's
    is dropped."""
    g = lambda k: snap[k].to(device)  # noqa: E731
    f = lambda k: g(k).double()  # noqa: E731
    warm = None
    if "warm0" in snap and not chained:
        warm = tuple(f(f"warm{i}") for i in range(4))
    leaves = lambda side: tuple(g(f"{side}{i}") for i in range(sum(k.startswith(side) for k in snap)))  # noqa: E731
    return dict(action=f("action"), soc_in=f("soc_in"), aux_in=f("aux_in"), terminated_in=g("terminated_in"),
                t_in=g("t_in").long(), task_in=leaves("task_in"), draw=f("draw"), warm=warm, chained=chained,
                obs=f("obs"), reward=f("reward"), done=g("done"), vm=f("vm"), vguess=f("vguess"),
                t_out=g("t_out").long(), terminated_out=g("terminated_out"), aux_out=f("aux_out"),
                soc_out=f("soc_out"), tap_out=f("tap_out"), task_out=leaves("task_out"))


def _lanes(d, sl):
    def cut(v):
        if isinstance(v, tuple):
            return tuple(w[sl] for w in v)
        return v[sl] if torch.is_tensor(v) else v

    return {k: cut(v) for k, v in d.items()}


class Gaps:
    """The widest gap of each number compared."""

    def __init__(self, limits):
        self.g = dict(vm_gap=0.0, va_gap=0.0, obs_gap=0.0, reward_gap=0.0, done_flips=0, state_flips=0,
                      reset_lanes=0)
        self.limits = limits
        self.failed_lanes = 0

    def take(self, name, value):
        value = float(value)
        if math.isnan(value) or value > self.g.get(name, 0.0):
            self.g[name] = value if not math.isnan(value) else math.inf


def _wmax(x, mask):
    return float(torch.where(mask, x, torch.zeros_like(x)).amax()) if x.numel() else 0.0


def compare(ref, d, gaps, precision="f64"):
    """Judge one block of one checked step against the reference; returns
    the reference's controller state to carry (None without a controller)."""
    net = ref.net
    B, dev = d["action"].shape[0], d["action"].device
    per_lane = torch.zeros(B, dtype=torch.bool, device=dev)
    carry = None
    if ref.lp is not None:
        a_ref, carry = ref.act(d["warm"], d["aux_in"], d["soc_in"], precision)
        gap = (d["action"] - a_ref).abs().amax(1)
        gaps.take("action_gap_mw", gap.max())
        per_lane |= ~(gap <= gaps.limits.get("action_gap_mw", math.inf))
    P_load, P_pot, aux = ref.rule.inputs(ref, d)
    out = grid.step(net, ref.task, dict(soc=d["soc_in"], terminated=d["terminated_in"]), d["action"],
                    P_load, P_pot, aux, precision)
    # done and the reward are the step's own on every lane; a lane the program reset
    # reports the fresh start's observation and state, which _bad_reset judges.
    reset = d["done"] if (ref.autoreset and d.get("autoreset", True)) else torch.zeros_like(d["done"])
    gaps.g["reset_lanes"] += int(reset.sum())
    keep = ~reset
    flips = d["done"] != out["done"]
    gaps.take("done_flips", gaps.g["done_flips"] + int(flips.sum()))
    live = keep & ~out["done"]  # the lanes the reference keeps alive; a disagreement on done also counts above
    vm_ref = torch.complex(out["v_re"], out["v_im"]).abs()
    va_ref = torch.atan2(out["v_im"], out["v_re"])[:, 1:]
    n_ns = net.n_bus - 1
    vm_gap = (d["vm"] - vm_ref).abs().amax(1)
    va_gap = (d["vguess"][:, :n_ns] - va_ref).abs().amax(1)
    obs_gap = ((d["obs"] - out["obs"]).abs() / (1.0 + out["obs"].abs())).amax(1)
    r_gap = torch.where(d["reward"] == out["reward"], torch.zeros_like(d["reward"]),
                        (d["reward"] - out["reward"]).abs() / (1.0 + out["reward"].abs()))
    # The reward is compared where done agrees and the reference resolves every branch's flow sign in float32.
    r_seen = ~flips & ~out["sign_unresolved"]
    gaps.take("vm_gap", _wmax(vm_gap, live))
    gaps.take("va_gap", _wmax(va_gap, live))
    gaps.take("obs_gap", _wmax(obs_gap, keep))
    gaps.take("reward_gap", _wmax(r_gap, r_seen))
    bad_state = keep & ((d["t_out"] != d["t_in"] + 1) | (d["terminated_out"] != out["done"])
                        | ref.rule.carry_flips(ref, d, aux))
    if reset.any():
        bad_state |= _bad_reset(ref, d, reset, gaps)
    gaps.take("state_flips", gaps.g["state_flips"] + int(bad_state.sum()))
    lim = lambda k: gaps.limits.get(k, math.inf)  # noqa: E731
    per_lane |= flips | bad_state
    per_lane |= live & ~((vm_gap <= lim("vm_gap")) & (va_gap <= lim("va_gap")))
    per_lane |= keep & ~(obs_gap <= lim("obs_gap"))
    per_lane |= r_seen & ~(r_gap <= lim("reward_gap"))
    gaps.failed_lanes += int(per_lane.sum())
    return carry


def _bad_reset(ref, d, reset, gaps):
    """The lanes reset in place that the exogenous rule finds no fresh start."""
    idx = torch.nonzero(reset).squeeze(1)
    full = torch.zeros_like(reset)
    full[idx] = ref.rule.fresh_start(ref, _lanes(d, idx), gaps)
    return full


def judge(ref, steps, limits, precision="f64"):
    """(readings, failed lanes) of the checked steps ``steps`` (dicts of
    :func:`observe`, in order) against the reference; ``precision`` is the
    reference's.  Besides the numbers compared, the readings count the
    lanes the program reset (``reset_lanes``)."""
    gaps = Gaps(limits)
    if ref.lp is not None:
        gaps.g["action_gap_mw"] = 0.0
    own = {}  # the reference's controller state a block of lanes, carried along the chained steps
    for d in steps:
        B = d["action"].shape[0]
        for lo in range(0, B, BLOCK):
            blk = _lanes(d, slice(lo, lo + BLOCK))
            if d["chained"]:
                blk["warm"] = own.get(lo)
            own[lo] = compare(ref, blk, gaps, precision)
    return gaps.g, gaps.failed_lanes


def control_steps(ref, steps):
    """The control: the reference at the precision below the configuration's
    (float32 with TF32 products) in the program's place, on the same inputs;
    along the chained steps it carries its own controller state."""
    out, own = [], {}
    for d in steps:
        c = dict(d, autoreset=False)
        if ref.lp is not None:
            acts = []
            for lo in range(0, d["action"].shape[0], BLOCK):
                warm = own.get(lo) if d["chained"] else _lanes(d, slice(lo, lo + BLOCK))["warm"]
                a, own[lo] = ref.act(warm, d["aux_in"][lo:lo + BLOCK], d["soc_in"][lo:lo + BLOCK], "tf32")
                acts.append(a)
            c["action"] = torch.cat(acts)
        parts = []
        for lo in range(0, c["action"].shape[0], BLOCK):
            sl = slice(lo, lo + BLOCK)
            P_load, P_pot, aux = ref.rule.inputs(ref, _lanes(d, sl))
            o = grid.step(ref.net, ref.task, dict(soc=d["soc_in"][sl], terminated=d["terminated_in"][sl]),
                          c["action"][sl], P_load, P_pot, aux, "tf32")
            parts.append((o, aux))
        cat = lambda f: torch.cat([f(o, a) for o, a in parts])  # noqa: E731
        c.update(obs=cat(lambda o, a: o["obs"]), reward=cat(lambda o, a: o["reward"]),
                 done=cat(lambda o, a: o["done"]),
                 vm=cat(lambda o, a: torch.complex(o["v_re"], o["v_im"]).abs()),
                 vguess=cat(lambda o, a: torch.cat([torch.atan2(o["v_im"], o["v_re"])[:, 1:],
                                                    torch.complex(o["v_re"], o["v_im"]).abs()[:, 1:]], 1)),
                 t_out=d["t_in"] + 1, terminated_out=cat(lambda o, a: o["done"]), aux_out=cat(lambda o, a: a),
                 soc_out=cat(lambda o, a: o["soc"]))
        out.append(c)
    return out


def verdict(readings, limits):
    """True where every reading is at most its limit."""
    return all(readings.get(k, 0.0) <= v for k, v in limits.items()) and all(
        not math.isnan(x) for x in readings.values())


def lines(readings, limits):
    """The numbers compared, each beside its limit."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits if k in readings}


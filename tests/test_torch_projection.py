"""gym_anm_torch's set-point projections and the transition with generators
and storage, against gym_anm_tpu on the same numpy-made inputs: the box +
sloped-line projector against the JAX package's and against the candidate
enumeration oracle ``project_polytope_2d``, against its line-by-line form
(``projection_lines``) bit for bit, its op count a call, the tables carried
over from JAX, and the float64 transition on the multicap network (5 generators, 6
capacitors) and on ANM6 (storage)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_anm_torch.convert import tables_from_jax
from gym_anm_torch.networks import anm6_network, create_multi_capacitor_network
from gym_anm_torch.physics.transition import make_tables, transition
from gym_anm_torch.specs import load_network
from gym_anm_tpu.physics import project_polytope_2d
from gym_anm_tpu.physics.transition import make_tables as j_make_tables, transition as j_transition

from . import projection_lines

transition_module = importlib.import_module("gym_anm_torch.physics.transition")  # the name is shadowed by the function

torch.set_num_threads(2)

NETWORKS = {"multicap": (create_multi_capacitor_network, 1.0), "anm6": (lambda: anm6_network, 0.25)}
B = 64


@pytest.fixture(scope="module", params=sorted(NETWORKS))
def both64(request):
    net, delta_t = NETWORKS[request.param]
    spec = load_network(net())
    return request.param, spec, j_make_tables(spec, delta_t, 100, dtype=jnp.float64), \
        make_tables(spec, delta_t, 100, dtype=torch.float64, device="cpu")


def _points(rng, lo, hi, shape):
    """Uniform points over [lo − span, hi + span]: inside and outside."""
    span = np.maximum(hi - lo, 1e-3)
    return rng.uniform(lo - span, hi + span, shape)


def _gen_case(spec, jtb, rng):
    gp = spec.gen_nonslack_pos
    p_pot = rng.uniform(spec.p_min[gp], spec.p_max[gp], (B, len(gp)))
    pts = np.stack([_points(rng, spec.p_min[gp], spec.p_max[gp], (B, len(gp))),
                    _points(rng, spec.q_min[gp], spec.q_max[gp], (B, len(gp)))], -1)
    p_hi = np.minimum(jtb.gen_p_hi_row, p_pot)
    A = np.broadcast_to(jtb.gen_A, (B,) + jtb.gen_A.shape)
    b = np.array(np.broadcast_to(jtb.gen_b_static, (B,) + jtb.gen_b_static.shape))
    b[..., 2] = p_pot
    return pts, np.broadcast_to(jtb.gen_p_lo_row, p_hi.shape), p_hi, A, b, jtb.gen_project, jtb.gen_pair, "gen"


def _des_case(spec, jtb, rng):
    dp = spec.des_pos
    soc = rng.uniform(spec.soc_min[dp], spec.soc_max[dp], (B, len(dp)))
    dt, eff = jtb.delta_t, jtb.des_eff
    p_lo = np.maximum(jtb.des_p_lo_row, (soc - jtb.des_soc_max) / (dt * eff))
    p_hi = np.minimum(jtb.des_p_hi_row, eff * (soc - jtb.des_soc_min) / dt)
    pts = np.stack([_points(rng, spec.p_min[dp], spec.p_max[dp], (B, len(dp))),
                    _points(rng, spec.q_min[dp], spec.q_max[dp], (B, len(dp)))], -1)
    A = np.broadcast_to(jtb.des_A, (B,) + jtb.des_A.shape)
    b = np.array(np.broadcast_to(jtb.des_b_static, (B,) + jtb.des_b_static.shape))
    b[..., 8], b[..., 9] = -p_lo, p_hi
    return pts, p_lo, p_hi, A, b, jtb.des_project, jtb.des_pair, "des"


def test_box_slopes_projector_matches_jax_and_oracle(both64):
    """ROADMAP P4: the box + slopes projector equals the candidate
    enumeration at 1e-9 in float64 (the bar tests/test_projection.py pins for
    the JAX projector), and the JAX projector at 1e-12 (same expressions)."""
    name, spec, jtb, ttb = both64
    rng = np.random.default_rng(3)
    cases = []
    if spec.n_gen:
        cases.append(_gen_case(spec, jtb, rng))
    if spec.n_des:
        cases.append(_des_case(spec, jtb, rng))
    assert cases
    n_moved = 0
    for pts, p_lo, p_hi, A, b, j_project, pair, fam in cases:
        t_project = ttb.gen_project if fam == "gen" else ttb.des_project
        out = t_project(torch.as_tensor(pts), torch.as_tensor(np.ascontiguousarray(p_lo)),
                        torch.as_tensor(p_hi)).numpy()
        ref = np.asarray(jax.vmap(j_project)(jnp.asarray(pts), jnp.asarray(p_lo), jnp.asarray(p_hi)))
        oracle = np.asarray(jax.vmap(lambda x, a, c: project_polytope_2d(x, a, c, pair))(
            jnp.asarray(pts), jnp.asarray(A), jnp.asarray(b)))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12, err_msg=f"{name} {fam} vs JAX projector")
        np.testing.assert_allclose(out, oracle, rtol=0, atol=1e-9, err_msg=f"{name} {fam} vs oracle")
        n_moved += int((np.abs(out - pts) > 1e-12).any(-1).sum())
    assert n_moved > B // 4, "too few points outside their polygons"


def test_tables_from_jax_rebuild_projectors(both64):
    """Tables carried over from JAX project like the port's own tables and
    hold the same generator and storage rows."""
    name, spec, jtb, ttb = both64
    ctb = tables_from_jax(jtb, device="cpu")
    for field in ("gen_p_lo_row", "gen_p_hi_row", "des_p_lo_row", "des_p_hi_row", "gen_p_min", "gen_p_max",
                  "des_soc_min", "des_soc_max", "des_eff", "gen_rer_mask", "gen_pos", "des_pos"):
        assert torch.equal(getattr(ctb, field), getattr(ttb, field)), field
    rng = np.random.default_rng(4)
    for fam, n in (("gen", spec.n_gen), ("des", spec.n_des)):
        if not n:
            assert getattr(ctb, f"{fam}_project") is None
            continue
        pts = torch.as_tensor(rng.uniform(-1, 1, (B, n, 2)))
        lo, hi = getattr(ttb, f"{fam}_p_lo_row"), getattr(ttb, f"{fam}_p_hi_row")
        torch.testing.assert_close(getattr(ctb, f"{fam}_project")(pts, lo, hi),
                                   getattr(ttb, f"{fam}_project")(pts, lo, hi), rtol=0, atol=0)


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_projector_equals_the_line_by_line_form_bit_for_bit(both64, dtype, monkeypatch):
    """Every family's projector against ``projection_lines`` bound to the
    same rows: equal bits (NaN for NaN) on points inside and outside, on
    the static p rows and on per-lane bounds, crossed bounds, exact ties,
    zeros, NaN and inf among them."""
    name, spec, _, _ = both64
    delta_t = NETWORKS[name][1]
    tb = make_tables(spec, delta_t, 100, dtype=dtype, device="cpu")
    monkeypatch.setattr(transition_module, "make_box_slopes_projector", projection_lines.make_box_slopes_projector)
    lines_tb = make_tables(spec, delta_t, 100, dtype=dtype, device="cpu")
    rng = np.random.default_rng(7)
    for fam in ("gen", "des"):
        project, reference = getattr(tb, f"{fam}_project"), getattr(lines_tb, f"{fam}_project")
        if project is None:
            continue
        lo_row, hi_row = getattr(tb, f"{fam}_p_lo_row"), getattr(tb, f"{fam}_p_hi_row")
        G = lo_row.numel()
        as_t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
        for trial in range(6):
            span = (0.05, 0.5, 2.0)[trial % 3]
            pts = as_t(rng.uniform(-span, span, (512, G, 2)))
            pts[:64] = torch.round(pts[:64] * 8) / 8
            pts[64:80] = 0.0
            bounds = [(lo_row, hi_row),
                      (lo_row, torch.minimum(hi_row, as_t(rng.uniform(-0.5, 1.0, (512, G))))),
                      (as_t(rng.uniform(-1, 1, (512, G))), as_t(rng.uniform(-1, 1, (512, G))))]
            lo, hi = bounds[trial % 3]
            if trial == 5:
                lo = lo.clone()
                lo[:4] = float("nan")
                pts[4:8, :, 0] = float("nan")
                pts[8:12] = float("inf")
            out, ref = project(pts, lo, hi), reference(pts, lo, hi)
            same = (_bits(out) == _bits(ref)) | (torch.isnan(out) & torch.isnan(ref))
            assert bool(same.all()), (name, fam, trial, int((~same).sum()))


class _OpCount(TorchDispatchMode):
    """Counts the ops that launch work (views left out)."""

    VIEWS = {"view", "expand", "select", "slice", "unsqueeze", "squeeze", "t", "_unsafe_view", "alias", "detach"}

    def __enter__(self):
        self.n = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.__name__.split(".")[0] not in self.VIEWS
        return func(*args, **(kwargs or {}))


def test_projector_calls_issue_few_ops(both64):
    """A call of each family's projector stays within 60 ops, whatever its
    number of lines (2 for generators, 4 for storage): what depends on the
    static rows alone is computed at binding.  It runs right after the
    autoreset's read, where the card waits on each op's enqueue."""
    name, spec, jtb, ttb = both64
    rng = np.random.default_rng(6)
    families = [fam for fam in ("gen", "des") if getattr(ttb, f"{fam}_project") is not None]
    assert families
    for fam in families:
        lo, hi = getattr(ttb, f"{fam}_p_lo_row"), getattr(ttb, f"{fam}_p_hi_row")
        pts = torch.as_tensor(rng.uniform(-1, 1, (B, lo.numel(), 2)))
        with _OpCount() as ops:
            getattr(ttb, f"{fam}_project")(pts, lo, hi.expand(B, -1))
        assert 0 < ops.n <= 60, (name, fam, ops.n)


def _transition_inputs(spec, rng):
    """Set-points over and beyond the action box, loads around nominal,
    potentials in [p_min, p_max], SoC in its range (p.u.)."""
    lo, hi = spec.action_bounds()
    a = _points(rng, lo, hi, (B, len(lo)))
    ng, nd, nc = spec.n_gen, spec.n_des, spec.n_cap
    P_gen, Q_gen = a[:, :ng], a[:, ng:2 * ng]
    P_des, Q_des = a[:, 2 * ng:2 * ng + nd], a[:, 2 * ng + nd:2 * ng + 2 * nd]
    Q_cap = a[:, 2 * ng + 2 * nd:2 * ng + 2 * nd + nc]
    taps = rng.uniform(spec.oltc_tap_min, spec.oltc_tap_max, (B, spec.n_oltc))
    base = spec.baseMVA
    P_load = spec.p_min[spec.load_pos] * base * rng.uniform(0.3, 1.0, (B, spec.n_load))
    gp, dp = spec.gen_nonslack_pos, spec.des_pos
    P_pot = rng.uniform(np.maximum(spec.p_min[gp], 0), spec.p_max[gp], (B, ng)) * base
    soc = rng.uniform(spec.soc_min[dp], spec.soc_max[dp], (B, nd))
    return P_load, P_pot, P_gen, Q_gen, P_des, Q_des, Q_cap, taps, soc


def test_transition_f64_with_generators_and_storage_matches_jax(both64):
    """The same lanes converge; on those, every TransitionOut field within
    1e-8 and equal Newton iteration counts.  (Set-points beyond the action
    box can collapse an ANM6 grid: such lanes diverge in both packages.)"""
    name, spec, jtb, ttb = both64
    args = _transition_inputs(spec, np.random.default_rng(5))
    rates = np.asarray(spec.br_rate, np.float64)
    out_t = transition(ttb, *map(torch.as_tensor, args), torch.as_tensor(rates))
    out_j = jax.jit(jax.vmap(lambda *a: j_transition(jtb, *a, jnp.asarray(rates))))(*map(jnp.asarray, args))
    ok = out_t.stable.numpy()
    np.testing.assert_array_equal(ok, np.asarray(out_j.stable))
    assert ok.sum() >= 0.75 * B
    np.testing.assert_array_equal(out_t.n_iter.numpy()[ok], np.asarray(out_j.n_iter)[ok])
    for field in out_t._fields:
        if field in ("stable", "n_iter"):
            continue
        np.testing.assert_allclose(getattr(out_t, field).numpy()[ok], np.asarray(getattr(out_j, field))[ok],
                                   rtol=0, atol=1e-8, err_msg=f"{name} {field}")
    if spec.n_gen:
        P_set = args[2] / spec.baseMVA
        assert (np.abs(out_t.dev_p[:, spec.gen_nonslack_pos].numpy() - P_set) > 1e-9).any(), "no projection moved"
    if spec.n_des:
        assert (np.abs(out_t.des_soc.numpy() - args[8]) > 1e-9).any(), "SoC never moved"

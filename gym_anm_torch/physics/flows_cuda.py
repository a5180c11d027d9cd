"""The transition's work after the load flow on the card: the wrapper of the
CUDA kernel K6, ``csrc/transition_flows.cu``, which computes the bus
currents, the measured slack injection, the branch flows and the reward of
every lane in one pass (the ``transition.flows`` span of the chord tier).

Its plain version is :func:`~gym_anm_torch.physics.transition.transition_flows_plain`;
:func:`~gym_anm_torch.physics.transition.transition_flows` picks between the
two by the tensors' device alone.
"""

import torch

from ..utils import profiling


_STATIC_ROWS = ("br_f", "br_t", "series_re", "series_im", "shunt_im", "shift_cos", "shift_sin", "tap0", "y0_re",
                "y0_im", "bus_v_min", "bus_v_max", "genload_pos", "gen_pos", "gen_rer_mask", "oltc_branch")
_INDEX = ("br_f", "br_t", "genload_pos", "gen_pos", "oltc_branch")
_TABLES_KEPT = 16
_tables_checked = {}  # id(tb) -> (tb, its device, its static rows' pointers), the last few tables checked


def _check(name, t, device, want, shape):
    if not (t.is_cuda and t.device == device):
        raise ValueError(f"transition_flows_cuda needs every tensor on one CUDA device: {name} is on {t.device}")
    if t.dtype != want:
        raise ValueError(f"transition_flows_cuda takes {want} {name}, got {t.dtype} (K6 runs the float32 tier)")
    if not t.is_contiguous():
        raise ValueError(f"transition_flows_cuda needs a contiguous {name}")
    if tuple(t.shape) != shape:
        raise ValueError(f"transition_flows_cuda expected {name} of shape {shape}, got {tuple(t.shape)}")


def _static_rows(tb):
    """(device, pointers of the static rows in ``_STATIC_ROWS``' order) of
    ``tb``, checked at its first call and kept for the next ones (the tables
    of an env do not change between steps)."""
    hit = _tables_checked.get(id(tb))
    if hit is not None and hit[0] is tb:
        return hit[1], hit[2]
    if tb.chord_t is None:
        raise ValueError("transition_flows_cuda runs the chord tier: the tables have no chord constants")
    N, Ne, G = tb.n_bus, tb.n_branch, int(tb.gen_pos.numel())
    n_oltc = int(tb.oltc_branch.numel())
    if n_oltc > 1:
        raise ValueError(f"transition_flows_cuda takes at most one OLTC (the chord tier's topologies), got {n_oltc}")
    rows = dict(tb._asdict(), y0_re=tb.chord_t.Y0re[0], y0_im=tb.chord_t.Y0im[0])
    shapes = dict(y0_re=(N,), y0_im=(N,), bus_v_min=(N,), bus_v_max=(N,), genload_pos=(tb.genload_pos.numel(),),
                  gen_pos=(G,), gen_rer_mask=(G,), oltc_branch=(n_oltc,),
                  **{k: (Ne,) for k in ("br_f", "br_t", "series_re", "series_im", "shunt_im", "shift_cos",
                                        "shift_sin", "tap0")})
    device = tb.br_f.device
    if not tb.br_f.is_cuda:
        raise ValueError(f"transition_flows_cuda needs every tensor on one CUDA device: br_f is on {device}")
    for name in _STATIC_ROWS:
        _check(name, rows[name], device, torch.int64 if name in _INDEX else torch.float32, shapes[name])
    ptrs = tuple(rows[name].data_ptr() for name in _STATIC_ROWS)
    if len(_tables_checked) >= _TABLES_KEPT:
        _tables_checked.pop(next(iter(_tables_checked)))
    _tables_checked[id(tb)] = (tb, device, ptrs)
    return device, ptrs


def transition_flows_cuda(tb, v_re, v_im, F, p_ns, q_ns, dy, tap_new, bus_p, bus_q, dev_p, dev_q, p_pot, rates):
    """The chord tier's flows of every lane in one launch of K6.

    Takes what :func:`~gym_anm_torch.physics.transition.transition_flows_plain`
    takes, as contiguous float32 tensors (index tables int64) on one CUDA
    device with ``tb`` a float32 ``GridTables`` with chord constants there,
    writes the slack injection into ``bus_p``, ``bus_q``, ``dev_p`` and
    ``dev_q`` in place, and returns the fields of ``transition.Flows`` in
    order.  Launches on the current stream, makes no host sync, and raises
    on anything else or on a failed launch.  The static rows of ``tb`` are
    checked at its first call, the lanes' tensors at every call.  Adds one to
    ``transition_flows_cuda.launch_count`` and B to the tracer's
    ``flows.lanes``.
    """
    device, static = _static_rows(tb)
    B, N = v_re.shape[0], tb.n_bus
    Ne, n_dev = tb.n_branch, tb.n_dev
    G, n_oltc = int(tb.gen_pos.numel()), int(tb.oltc_branch.numel())
    if B == 0:
        raise ValueError("transition_flows_cuda needs a non-empty batch")
    if tuple(rates.shape) not in ((Ne,), (B, Ne)):
        raise ValueError(f"transition_flows_cuda expected rates of shape ({Ne},) or ({B}, {Ne}), got "
                         f"{tuple(rates.shape)}")
    lane = (("v_re", v_re, (B, N)), ("v_im", v_im, (B, N)), ("F", F, (B, 2 * (N - 1))), ("p_ns", p_ns, (B, N - 1)),
            ("q_ns", q_ns, (B, N - 1)), ("dff_re", dy[0], (B,)), ("dff_im", dy[1], (B,)), ("dft_re", dy[2], (B,)),
            ("dft_im", dy[3], (B,)), ("tap_new", tap_new, (B, n_oltc)), ("bus_p", bus_p, (B, N)),
            ("bus_q", bus_q, (B, N)), ("dev_p", dev_p, (B, n_dev)), ("dev_q", dev_q, (B, n_dev)),
            ("p_pot", p_pot, (B, G)), ("rates", rates, tuple(rates.shape)))
    for name, t, shape in lane:
        _check(name, t, device, torch.float32, shape)
    from .._build import load_library

    lib = load_library()
    out = [torch.empty(B, N, dtype=torch.float32, device=device) for _ in range(2)]
    out += [torch.empty(B, Ne, dtype=torch.float32, device=device) for _ in range(9)]
    out += [torch.empty(B, dtype=torch.float32, device=device) for _ in range(3)]
    ptr = lambda t: t.data_ptr()  # noqa: E731
    oltc = n_oltc == 1
    (br_f, br_t, series_re, series_im, shunt_im, shift_cos, shift_sin, tap0, y0r, y0i, v_min, v_max, genload,
     gen_pos, rer_mask, oltc_branch) = static
    args = (*map(ptr, (v_re, v_im, F, p_ns, q_ns, *dy)), ptr(tap_new) if oltc else None,
            oltc_branch if oltc else None, ptr(p_pot), ptr(rates), br_f, br_t, series_re, series_im, shunt_im,
            shift_cos, shift_sin, tap0, y0r, y0i, v_min, v_max, genload, gen_pos, rer_mask,
            *map(ptr, (bus_p, bus_q, dev_p, dev_q)), *map(ptr, out), float(tb.delta_t), float(tb.lamb),
            int(rates.dim() == 2), B, N, Ne, n_dev, int(tb.genload_pos.numel()), G, int(tb.chord.t_bus),
            int(tb.slack_bus), int(tb.slack_dev))
    with torch.cuda.device(device):
        rc = lib.transition_flows_f32(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transition_flows kernel launch failed with CUDA error {rc} (B={B}, N={N}, Ne={Ne})")
    transition_flows_cuda.launch_count += 1
    profiling.count("flows.lanes", B)
    return tuple(out)


transition_flows_cuda.launch_count = 0

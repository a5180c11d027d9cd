"""The exact-Newton fallback on the card: the wrapper of the CUDA kernel
``csrc/newton_fallback.cu`` (K3), which runs the whole Newton loop of every
lane that still iterates in one launch: a triage pass over every lane, then
groups of threads that take the iterating lanes from a device worklist and
spread each lane's Gauss-Jordan sweeps over several threads a row.  It
replaces the reference's device loop
``gym_anm_tpu/physics/power_flow.py:nr_solve_lazy`` (and the same loop in
``nr_solve``).

Its plain version is
:func:`~gym_anm_torch.physics.power_flow._newton_loop`;
:func:`~gym_anm_torch.physics.power_flow.nr_solve_lazy` and
:func:`~gym_anm_torch.physics.power_flow.nr_solve` pick between the two by
the tensors' device alone (and by n: above ``MAX_N`` the card runs the plain
loop around K1's panel routes).
"""

import torch

from .ybus import LaneYbus

# Largest n = 2 (N_bus - 1): a lane's system held in its group's registers
# (networks of up to 33 buses: IEEE33, n = 64).
MAX_N = 64


def _lane_vectors(x, F, diff, n_iter, accepted, p, q):
    B, nb = p.shape
    want = ((x, (B, 2 * nb)), (F, (B, 2 * nb)), (diff, (B,)), (n_iter, (B,)), (p, (B, nb)), (q, (B, nb)))
    if accepted is not None:
        want += ((accepted, (B,)),)
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"newton_fallback_cuda expected a tensor of shape {shape}, got {tuple(t.shape)}")
    if any(t.dtype != p.dtype for t in (x, F, diff, q)):
        raise ValueError("newton_fallback_cuda needs x, F, diff, p and q of one type")
    if n_iter.dtype != torch.int32 or (accepted is not None and accepted.dtype != torch.bool):
        raise ValueError("newton_fallback_cuda needs n_iter as int32 and accepted as bool")
    return [t for t, _ in want]


def k3_arguments(x, F, diff, n_iter, accepted, p, q, ybus):
    """Checks :func:`newton_fallback_cuda`'s arguments and allocates its
    outputs: ``(kind, args, outs)``, the Y source (``"lane_ybus"`` or
    ``"dense"``), the kernel's pointer arguments from ``x`` to ``n_branch``
    and the outputs ``(x, F, diff, n_iter, stall)``.  Raises on anything the
    kernel does not take."""
    device, dtype = p.device, p.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_fallback_cuda takes float32 or float64, got {dtype}")
    if p.dim() != 2:
        raise ValueError(f"expected p [B, n/2], got {tuple(p.shape)}")
    B, nb = p.shape
    N = nb + 1
    lane_vecs = _lane_vectors(x, F, diff, n_iter, accepted, p, q)
    if isinstance(ybus, LaneYbus):
        kind = "lane_ybus"
        floats = (ybus.series_re, ybus.series_im, ybus.shunt_im, ybus.shift_cos, ybus.shift_sin, ybus.tap_magn)
        tables = (ybus.f, ybus.t) + floats
        Ne = ybus.f.shape[0]
        if ybus.n_bus != N or any(tuple(t.shape) != (Ne,) for t in tables[:-1]) or \
                tuple(ybus.tap_magn.shape) != (B, Ne):
            raise ValueError(f"LaneYbus does not match the lanes: {N} buses, taps [{B}, {Ne}]")
        if ybus.f.dtype != torch.int64 or ybus.t.dtype != torch.int64 or any(t.dtype != dtype for t in floats):
            raise ValueError("newton_fallback_cuda needs LaneYbus's f and t as int64 and its tables in the lanes' type")
        if Ne == 0:
            raise ValueError("newton_fallback_cuda needs a network with branches")
    else:
        kind = "dense"
        tables = tuple(ybus)
        if len(tables) != 2 or any(t.dtype != dtype for t in tables):
            raise ValueError("newton_fallback_cuda takes a LaneYbus or a pair (Yre, Yim) in the lanes' type")
        shape = tuple(tables[0].shape)
        if shape not in ((B, N, N), (N, N)) or tuple(tables[1].shape) != shape:
            raise ValueError(f"expected Yre, Yim [{B}, {N}, {N}] or [{N}, {N}], got {shape}")
    if not all(t.is_cuda and t.device == device for t in lane_vecs + list(tables)):
        raise ValueError("newton_fallback_cuda needs every tensor on one CUDA device")
    if not all(t.is_contiguous() for t in lane_vecs + list(tables)):
        raise ValueError("newton_fallback_cuda needs contiguous tensors")
    if B == 0 or not 1 <= nb <= MAX_N // 2:
        raise ValueError(f"newton_fallback_cuda needs a non-empty batch and 2 <= n <= {MAX_N} (networks of at "
                         f"most {MAX_N // 2 + 1} buses), got B={B}, n={2 * nb}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if kind == "dense":
        y_args = (ptr(tables[0]), ptr(tables[1]), N * N if len(shape) == 3 else 0) + (None,) * 8 + (0,)
    else:
        y_args = (None, None, 0) + tuple(ptr(t) for t in tables) + (Ne,)
    args = (ptr(x), ptr(F), ptr(diff), ptr(n_iter), ptr(accepted), ptr(p), ptr(q)) + y_args
    outs = (torch.empty_like(x), torch.empty_like(F), torch.empty_like(diff), torch.empty_like(n_iter),
            torch.empty_like(n_iter))
    return kind, args, outs


def newton_fallback_cuda(x, F, diff, n_iter, accepted, p, q, ybus, xtol=1e-5, lim_iter=100):
    """The Newton loop of every lane in one launch of the CUDA kernel.

    Takes the loop's start ``x``, ``F`` [B, n], ``diff``, ``n_iter`` [B]
    (int32; the chord's, or zeros), ``accepted`` [B] (bool, or None where no
    lane is) and the injections ``p``, ``q`` [B, n/2], float32 or float64
    contiguous tensors on one CUDA device, and the Y-bus as a
    :class:`~gym_anm_torch.physics.ybus.LaneYbus` on that device (each lane's
    matrix built in the kernel from the branch tables and its taps) or a
    pair ``(Yre, Yim)`` of [B, N, N] or [N, N].  Returns ``(x, F, diff,
    n_iter, stall)`` as :func:`~gym_anm_torch.physics.power_flow._newton_loop`
    returns them, for :func:`~gym_anm_torch.physics.power_flow._nr_result`.
    Launches on the current stream; raises on anything else (n above
    ``MAX_N`` included) or on a failed launch.  Adds one to
    ``newton_fallback_cuda.launch_count`` per launch, and to
    ``newton_fallback_cuda.launches["lane_ybus"]`` or ``["dense"]`` for the
    Y source.
    """
    kind, args, outs = k3_arguments(x, F, diff, n_iter, accepted, p, q, ybus)
    from .._build import load_library

    lib = load_library()
    B, nb = p.shape
    device, dtype = p.device, p.dtype
    fn = lib.newton_fallback_f64 if dtype == torch.float64 else lib.newton_fallback_f32
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # The worklist's length, its next item and the grid barrier's
        # arrivals, then the worklist: one allocation and one fill.
        scratch = torch.zeros(3 + B, dtype=torch.int32, device=device)
        rc = fn(*args, float(xtol), int(lim_iter), *(t.data_ptr() for t in outs), scratch.data_ptr(),
                scratch.data_ptr() + 3 * scratch.element_size(), B, nb, stream)
    if rc != 0:
        raise RuntimeError(f"newton_fallback kernel launch failed with CUDA error {rc} "
                           f"(B={B}, n={2 * nb}, {dtype}, {kind})")
    newton_fallback_cuda.launch_count += 1
    newton_fallback_cuda.launches[kind] += 1
    return outs


newton_fallback_cuda.launch_count = 0
newton_fallback_cuda.launches = {"lane_ybus": 0, "dense": 0}

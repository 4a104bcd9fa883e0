"""Grouped (per-expert) matmul: CUDA kernels K4a (forward) and K4b (weight
gradient) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/grouped_matmul.py``. Over rows
sorted by group, ``out[r] = lhs[r] @ rhs[group(r)]``: lhs ``[M, K]``, rhs
``[G, K, N]``, ``group_sizes [G]`` an integer tensor whose values are a
runtime (data-dependent) routing result. Rows past ``sum(group_sizes)`` are
padding and come out as zeros. Products accumulate in f32 and the output
takes lhs's dtype. The backward is the reference's ``_gmm_bwd``: dlhs =
K4a on ``(dout, rhs^T)``, cast to lhs's dtype; drhs ``[G, K, N]`` f32 from
K4b (``drhs[g] = lhs_g^T @ dout_g``, zero for an empty group), cast to
rhs's dtype.

The plain versions loop over the groups on the host (they read the sizes
there) and serve CPU tensors. The CUDA wrappers keep ``group_sizes`` on the
device: the kernels find each group's rows from its exclusive cumsum,
computed on the device, so a launch never waits on the host. Operands are
passed with their element strides: dlhs reads ``rhs.transpose(1, 2)`` in
place, and only a view with no unit stride in its last two dims is copied.

:func:`grouped_matmul` runs :class:`GroupedMatmulFunction`: CPU tensors
take the plain versions, CUDA tensors launch the hand-written kernels
(``ops/cuda/grouped_matmul.cu``) or raise. ``launches_fwd`` (K4a, forward
and dlhs) and ``launches_drhs`` (K4b) count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches of K4a and K4b (plain counts; callers reset them to 0
#: around a run they want to attribute)
launches_fwd = 0
launches_drhs = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535          # grid y / z limit: K4b's k tiles and groups
_TILE = 128                # the kernels' output tile rows (K4b: k)


# ------------------------------------------------------------- plain versions

def _spans(group_sizes, m):
    """(group, first row, end row) of each group, clipped to ``m`` rows."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        yield g, min(start, m), min(start + int(size), m)
        start += int(size)


def grouped_matmul_plain(lhs, rhs, group_sizes):
    """Plain version of K4a (``_gmm_forward``): ``[M, N]`` in lhs's dtype,
    f32 products per group, zero rows past the groups."""
    m, n = lhs.shape[0], rhs.shape[2]
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    for g, s, e in _spans(group_sizes, m):
        if e > s:
            out[s:e] = lhs[s:e].float() @ rhs[g].float()
    return out.to(lhs.dtype)


def grouped_matmul_drhs_plain(lhs, dout, group_sizes):
    """Plain version of K4b (``_gmm_drhs``): ``drhs[g] = lhs_g^T @ dout_g``,
    ``[G, K, N]`` f32, zero for an empty group."""
    k, n = lhs.shape[1], dout.shape[1]
    drhs = torch.zeros((group_sizes.shape[0], k, n), dtype=torch.float32,
                       device=lhs.device)
    for g, s, e in _spans(group_sizes, lhs.shape[0]):
        if e > s:
            drhs[g] = lhs[s:e].float().T @ dout[s:e].float()
    return drhs


# ------------------------------------------------------------------ checks

def _check(lhs, rhs, group_sizes):
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"expected lhs [M, K] and rhs [G, K, N], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    if lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"lhs K={lhs.shape[1]} != rhs K={rhs.shape[1]}")
    if tuple(group_sizes.shape) != (rhs.shape[0],):
        raise ValueError(f"group_sizes must be [G] = [{rhs.shape[0]}], got "
                         f"{tuple(group_sizes.shape)}")
    if group_sizes.is_floating_point() or group_sizes.is_complex():
        raise TypeError(f"group_sizes must be integer, got "
                        f"{group_sizes.dtype}")


def _check_cuda(lhs, other, group_sizes):
    """Device, dtype and grid-size checks of a launch; ``other`` is rhs
    (K4a) or dout (K4b)."""
    if lhs.device.type != "cuda":
        raise ValueError(f"the grouped-matmul kernels take cuda tensors, "
                         f"got {lhs.device}")
    if lhs.dtype not in _DTYPES or other.dtype != lhs.dtype:
        raise TypeError(f"operands must share one dtype of "
                        f"{tuple(_DTYPES)}, got {lhs.dtype} / {other.dtype}")
    for x in (other, group_sizes):
        if x.device != lhs.device:
            raise ValueError(f"all inputs must be on {lhs.device}, got a "
                             f"tensor on {x.device}")
    if max(-(-lhs.shape[1] // _TILE), group_sizes.shape[0]) > _MAX_GRID:
        raise ValueError(f"too many k tiles or groups for one launch: lhs "
                         f"{tuple(lhs.shape)}, {group_sizes.shape[0]} "
                         f"groups")


# ------------------------------------------------------------ CUDA launches

def _unit_view(x):
    """``x`` as the kernels read it: any strides, as long as one of the
    last two dims has unit stride (a transposed view is read in place);
    anything else is copied."""
    return x if 1 in x.stride()[-2:] else x.contiguous()


def _vec(k, n, *operands):
    """True when every operand moves in whole 16-byte chunks, the kernels'
    cp.async loads (8 bf16 or 4 f32 elements): K and N multiples of a
    chunk, and each operand 16-byte aligned at its base, with unit stride
    along its contiguous dim and every other stride a multiple of a chunk.
    ``operands``: (tensor, its contiguous dim) pairs of one dtype."""
    chunk = 16 // operands[0][0].element_size()
    if k % chunk or n % chunk:
        return False
    for x, dim in operands:
        if x.data_ptr() % 16 or x.stride(dim) != 1:
            return False
        if any(st % chunk for d, st in enumerate(x.stride()) if d != dim):
            return False
    return True


def _offsets(group_sizes):
    """Exclusive cumsum ``[G + 1]`` int32 of the sizes, on their device."""
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    return torch.nn.functional.pad(ends, (1, 0))


def _call(name, device, *args):
    from .cuda.build import library

    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def grouped_matmul_cuda(lhs, rhs, group_sizes):
    """Launch K4a; same contract as :func:`grouped_matmul_plain`. ``rhs``
    may be a strided view (``w.transpose(1, 2)`` for dlhs)."""
    global launches_fwd
    _check(lhs, rhs, group_sizes)
    _check_cuda(lhs, rhs, group_sizes)
    m, k = lhs.shape
    g, _, n = rhs.shape
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    lhs, rhs = _unit_view(lhs), _unit_view(rhs)
    # rhs read along k (a transposed view) or along n
    k_contig = rhs.stride(1) == 1 and rhs.stride(2) != 1
    vec = _vec(k, n, (lhs, 1), (rhs, 1 if k_contig else 2))
    strides = (ctypes.c_longlong * 5)(*lhs.stride(), *rhs.stride())
    _call("paddle_grouped_matmul_fwd", lhs.device, lhs.data_ptr(),
          rhs.data_ptr(), _offsets(group_sizes).data_ptr(), out.data_ptr(),
          strides, m, k, n, g, _DTYPES[lhs.dtype], int(k_contig), int(vec))
    launches_fwd += 1
    return out


def grouped_matmul_drhs_cuda(lhs, dout, group_sizes):
    """Launch K4b; same contract as :func:`grouped_matmul_drhs_plain`."""
    global launches_drhs
    if dout.dim() != 2 or dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"dout must be [M, N] with M={lhs.shape[0]}, got "
                         f"{tuple(dout.shape)}")
    _check_cuda(lhs, dout, group_sizes)
    m, k = lhs.shape
    n, g = dout.shape[1], group_sizes.shape[0]
    drhs = torch.empty((g, k, n), dtype=torch.float32, device=lhs.device)
    if drhs.numel() == 0:
        return drhs
    lhs, dout = _unit_view(lhs), _unit_view(dout)
    vec = _vec(k, n, (lhs, 1), (dout, 1))
    strides = (ctypes.c_longlong * 4)(*lhs.stride(), *dout.stride())
    _call("paddle_grouped_matmul_drhs", lhs.device, lhs.data_ptr(),
          dout.data_ptr(), _offsets(group_sizes).data_ptr(), drhs.data_ptr(),
          strides, m, k, n, g, _DTYPES[lhs.dtype], int(vec))
    launches_drhs += 1
    return drhs


def _is_cuda(x):
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions); other devices raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type == "cuda"


class GroupedMatmulFunction(torch.autograd.Function):
    """Grouped matmul with the reference's ``_gmm`` custom VJP; dlhs and
    drhs run only for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        fwd = grouped_matmul_cuda if _is_cuda(lhs) else grouped_matmul_plain
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return fwd(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        cuda = _is_cuda(lhs)
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            fwd = grouped_matmul_cuda if cuda else grouped_matmul_plain
            dlhs = fwd(dout, rhs.transpose(1, 2), group_sizes).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            bwd = (grouped_matmul_drhs_cuda if cuda
                   else grouped_matmul_drhs_plain)
            drhs = bwd(lhs, dout, group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def grouped_matmul(lhs, rhs, group_sizes, block_m=None, block_n=None,
                   interpret=None):
    """``out[rows of group g] = lhs[rows of group g] @ rhs[g]``, ragged
    groups.

    Args:
      lhs: ``[M, K]`` rows sorted by group (group-contiguous). Rows past
        ``sum(group_sizes)`` are padding and produce zero rows.
      rhs: ``[G, K, N]`` per-group weights, the same dtype as lhs.
      group_sizes: ``[G]`` integers (a tensor, which may be a device-side
        routing result, or a sequence); ``sum(group_sizes) <= M``.
      block_m, block_n, interpret: accepted for the reference's signature
        and ignored (TPU tiling); any M and N are taken as they are.

    Returns ``[M, N]`` in lhs's dtype. CUDA tensors need f32 or bf16.
    """
    if not torch.is_tensor(group_sizes):
        group_sizes = torch.as_tensor(group_sizes, dtype=torch.int32,
                                      device=lhs.device)
    _check(lhs, rhs, group_sizes)
    return GroupedMatmulFunction.apply(lhs, rhs, group_sizes.to(torch.int32))


__all__ = ["GroupedMatmulFunction", "grouped_matmul", "grouped_matmul_cuda",
           "grouped_matmul_drhs_cuda", "grouped_matmul_drhs_plain",
           "grouped_matmul_plain"]

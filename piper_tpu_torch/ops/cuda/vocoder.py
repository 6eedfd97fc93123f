"""The HiFiGAN vocoder kernels: CUDA C++ for Hopper, and their plain versions.

Counterpart of piper_tpu/ops/pallas/vocoder.py. Its two Pallas TPU
kernels become hand-written CUDA kernels (csrc/mrf_fused.cu,
csrc/fused_upsample_mrf.cu), built with nvcc for sm_90a at first use
into build/piper_tpu_torch/ at the checkout root, and bound with ctypes
through a plain C interface.

  mrf_fused            one MRF stage (resblock stack, mean), time-major
  fused_upsample_mrf   lrelu -> polyphase ConvTranspose1d -> MRF
                       [-> conv_post -> tanh], phase-plane layouts

Each kernel has one body, a template on the element type, on the tensor
cores (csrc/tc_common.cuh: wgmma, with the weights fed through a ring of
shared stages by bulk copies of the Tensor Memory Accelerator): bfloat16
(serving) in bf16 products, float32 (parity) in 3xTF32 products (each
operand split into tf32 hi and lo, three products a unit). The bodies
read their weights in a kernel layout (tc_weights: K-major core matrices
of 8 rows x 16 bytes, the layout the wgmma descriptor reads; bf16
tc_weight_layout, float32 tf32_weight_layout with its hi and lo planes),
made once per weight tensor (prepare_tm in models/vits/generator.py makes
it for the voice's weights). Their tiles come from their shared-memory
layouts, mirrored here: bf16 mrf_tc_layout / fused_tc_layout
(mrf_fused.cu::mrf_tc_layout, fused_upsample_mrf.cu::tc_layout), float32
mrf_tf32_layout / fused_tf32_layout (mrf_fused.cu::mrf_tf32_layout,
fused_upsample_mrf.cu::tf32_layout), each with its fits test.

Each wrapper takes its plain PyTorch version (`*_plain`, same signature
and output layout) only when the input lies on the CPU. For a CUDA
tensor it launches the kernel or raises; a failed build raises too.
Each wrapper counts its kernel launches in a plain integer attribute
(`mrf_fused.launches`, `fused_upsample_mrf.launches`), and by dtype
(`mrf_fused.by_dtype["float32"].launches`, ...), bumped under a lock
(`count_launch`) so the counts stay exact when several threads launch (a
server's request handlers, its batcher, a background warm-up).
A CUDA graph's capture launches nothing: inside recording_launches the
wrappers record their launches for the graph, and runtime/graphs.py
adds them to the counts at every replay.

The kernels choose their own time tiles against the 227 KB of shared
memory a block may use, so the output of fused_upsample_mrf is exactly V
frames wide (the TPU kernel pads V to its tile).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "piper_tpu_torch"
SOURCES = {"mrf_fused": "mrf_fused.cu", "fused_upsample_mrf": "fused_upsample_mrf.cu"}
HEADERS = ("mrf_common.cuh", "tc_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
THREADS = 256  # consumer threads per block (csrc/mrf_common.cuh: kThreads)
# The bodies (csrc/tc_common.cuh): warpgroups per block (kGroups),
# 16-channel chunks per bf16 weight stage (kMaxChunks), the ring's stages
# (kRingMin, kRingMax) and the bytes of its mbarriers (kBarBytes).
TC_GROUPS = 2
TC_MAX_CHUNKS = 4
TC_RING_MIN, TC_RING_MAX = 3, 8
TC_BAR_BYTES = 128
MAX_TILE = 4096


# ---------------------------------------------------------------------------
# Stage plan and weight packing (vocoder.py:42-62, 184-218)
# ---------------------------------------------------------------------------


def stage_plan(
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    resblock_type: str,
) -> Tuple[List[List[Tuple[int, int]]], int]:
    """Per-resblock list of (kernel, dilation) conv steps + halo."""
    blocks: List[List[Tuple[int, int]]] = []
    for k, dils in zip(kernel_sizes, dilation_sizes):
        steps: List[Tuple[int, int]] = []
        for d in dils:
            steps.append((k, d))
            if resblock_type == "1":
                steps.append((k, 1))
        blocks.append(steps)
    halo = max(sum((k * d - d) // 2 for k, d in steps) for steps in blocks)
    return blocks, halo


def pack_stage_weights(
    resblock_params: Sequence[Dict[str, Any]],
    kernel_sizes: Sequence[int],
    dilation_sizes: Sequence[Sequence[int]],
    resblock_type: str,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a stage's conv weights into (n_convs, k_max, C, C) + biases
    (n_convs, C, 1) float32. Per tap the layout is (C_in, C_out), as the
    tree stores kernels (k, C_in, C_out)."""
    convs, biases = [], []
    for p in resblock_params:
        if resblock_type == "1":
            for c1, c2 in zip(p["convs1"], p["convs2"]):
                convs += [c1["w"], c2["w"]]
                biases += [c1["b"], c2["b"]]
        else:
            for cp in p["convs"]:
                convs.append(cp["w"])
                biases.append(cp["b"])
    convs = [torch.as_tensor(w) for w in convs]
    k_max = max(w.shape[0] for w in convs)
    c = convs[0].shape[-1]
    packed = convs[0].new_zeros((len(convs), k_max, c, c), dtype=torch.float32)
    for i, w in enumerate(convs):
        packed[i, : w.shape[0]] = w.float()
    packed_b = torch.stack([torch.as_tensor(b).float() for b in biases])[..., None]
    return packed.to(dtype).contiguous(), packed_b.contiguous()


def mrf_plan_ints(
    kernel_sizes, dilation_sizes, resblock_type: str, k_max: int
) -> List[int]:
    """The stage plan as the kernels' C interface takes it
    (csrc/mrf_common.cuh::parse_plan)."""
    blocks, _ = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    ints = [len(blocks), int(resblock_type == "1"), k_max]
    ints += [len(steps) for steps in blocks]
    for steps in blocks:
        for k, d in steps:
            ints += [k, d]
    return ints


def _margin(kernel_sizes, dilation_sizes) -> int:
    return max(
        (k * d - d) // 2 for k, ds in zip(kernel_sizes, dilation_sizes) for d in ds
    )


# ---------------------------------------------------------------------------
# Shared-memory sizing (replaces the VMEM sizing of vocoder.py:242-256,
# 626-651 and fused_stage_vmem_ok, vocoder.py:731)
# ---------------------------------------------------------------------------


def _al(n: int) -> int:
    return (n + 7) & ~7


def mrf_smem_bytes(c, tile, halo, margin, rb1, esize) -> int:
    """The stage split's shared-memory rule for an MRF stage
    (models/vits/generator.py::tm_start_stage, at SPLIT_ESIZE): a
    channel-major layout of the conv input with margins, the residual
    stream (and resblock "1"'s inner output) and the resblock sum. No
    kernel runs this layout; the split keeps it so that every preset
    keeps its stages (tests/test_torch_launch_config.py)."""
    w = tile + 2 * halo
    n = _al(c * (w + 2 * margin)) + _al(c * w) * (2 if rb1 else 1) + _al(c * tile)
    return n * esize


def fused_smem_bytes(c_in, c_out, u, nq, tile, halo, hpost, margin, rb1, esize) -> int:
    """The stage split's shared-memory rule for a fused stage
    (generator.py::fused_suffix_start), as mrf_smem_bytes is for an MRF
    stage."""
    w = tile + 2 * halo
    n = (
        _al(c_out * (w + 2 * margin))
        + _al(c_out * w) * (3 if rb1 else 2)
        + _al(c_out * (tile + 2 * hpost))
        + c_in * _ld_in(w, u, nq)
    )
    return n * esize


def _ld_in(w: int, u: int, nq: int) -> int:
    return (w + u - 1) // u + nq + 1


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _npad(cp: int) -> int:
    """Width of the bf16 bodies' warpgroup product for cp padded output
    channels: the power of two from 16 to 256 at or above it, 0 if wider
    (tc_common.cuh::npad)."""
    n = 16
    while n < cp:
        n *= 2
    return n if n <= 256 else 0


def _mt_per_group(n: int) -> int:
    """64-row output tiles one warpgroup holds at product width n."""
    return 1 if n >= 256 else 2 if n >= 128 else 3 if n >= 64 else 4


def _step_rows(k: int, n: int) -> int:
    """Input-channel rows of one step: 16, 32 or 64, at most 16 KB,
    dividing k (tc_common.cuh::step_rows)."""
    r = 16 * TC_MAX_CHUNKS
    while r > 16 and (r * n * 2 > 16384 or k % r):
        r //= 2
    return r


def _stage_taps(k: int, n: int) -> int:
    """Taps of one weight stage: several where a whole tap is one step of
    fewer than 4 chunks (k = 16, 32) and the product is at most 64 wide,
    up to 4 chunks and 16 KB together; else 1 (tc_common.cuh::stage_taps)."""
    if n > 64 or _step_rows(k, n) != k:
        return 1
    t = 16 * TC_MAX_CHUNKS // k
    while t > 1 and t * k * n * 2 > 16384:
        t -= 1
    return t


def _ring(windows: int, slot: int) -> Tuple[int, int]:
    """(stages, offset of the first window): as many stages as fit beside
    the windows, from TC_RING_MIN to TC_RING_MAX (tc_common.cuh::ring_slots)."""
    n = TC_RING_MIN
    while n < TC_RING_MAX and TC_BAR_BYTES + (n + 1) * slot + windows <= SMEM_LIMIT:
        n += 1
    return n, TC_BAR_BYTES + n * slot


def mrf_tc_layout(c, tile, halo) -> Dict[str, int]:
    """Shared-memory layout of mrf_fused.cu's bf16 body, in bytes, field
    by field as csrc/mrf_fused.cu::mrf_tc_layout: the ring's mbarriers and
    weight stages, then position-major windows with rows of round16(C) + 8
    bf16 for the two conv inputs and the residual stream (w rows each) and
    the resblock sum (tile rows)."""
    cp = _r16(c)
    np_ = _npad(cp)
    ldc, w = cp + 8, tile + 2 * halo
    step = _step_rows(cp, np_) if np_ else 16
    taps = _stage_taps(cp, np_) if np_ else 1
    slot, row = taps * step * np_ * 2, 2 * ldc
    n_slots, a0 = _ring((3 * w + tile) * row, slot)
    return dict(
        cp=cp, np=np_, ldc=ldc, w=w, step_rows=step, taps=taps, slot_bytes=slot, n_slots=n_slots,
        bar=0, ring=TC_BAR_BYTES, a0=a0, a1=a0 + w * row, h=a0 + 2 * w * row,
        xs=a0 + 3 * w * row, bytes=a0 + (3 * w + tile) * row,
    )


def mrf_smem_bytes_tc(c, tile, halo) -> int:
    """Bytes of shared memory the bf16 body of mrf_fused.cu takes."""
    return mrf_tc_layout(c, tile, halo)["bytes"]


def _layout_fits(lay: Dict[str, int], c: int, rows: int) -> bool:
    """Whether a body runs a layout of `c` output channels whose GEMMs
    span up to `rows` rows: a product width of at most 256, the 64-row
    output tiles within the two warpgroups' registers, the layout within
    shared memory."""
    return (
        c % 4 == 0 and lay["np"] > 0
        and -(-rows // 64) <= TC_GROUPS * _mt_per_group(lay["np"])
        and lay["bytes"] <= SMEM_LIMIT
    )


def mrf_tc_fits(c, tile, halo) -> bool:
    """Whether the bf16 body of mrf_fused runs this tile."""
    lay = mrf_tc_layout(c, tile, halo)
    return _layout_fits(lay, c, lay["w"])


def fused_tc_layout(c_in, c_out, u, nq, tile, halo, hpost) -> Dict[str, int]:
    """Shared-memory layout of fused_upsample_mrf.cu's bf16 body, in
    bytes, field by field as csrc/fused_upsample_mrf.cu::tc_layout: the
    ring's mbarriers and weight stages, then position-major windows for
    the two conv inputs, the residual stream and the transposed conv's
    output (w rows each), the resblock sum (tile + 2 hpost rows) and the
    input frames (rows of round16(C_in) + 8 bf16)."""
    cp, cip = _r16(c_out), _r16(c_in)
    np_ = _npad(cp)
    ldc, ldi = cp + 8, cip + 8
    w, xs_w = tile + 2 * halo, tile + 2 * hpost
    n_fr = (w + u - 2) // u + 1
    in_rows = n_fr + nq - 1
    st_t = _step_rows(cip, np_) if np_ else 16
    st_c = _step_rows(cp, np_) if np_ else 16
    taps_t = _stage_taps(cip, np_) if np_ else 1
    taps_c = _stage_taps(cp, np_) if np_ else 1
    slot, row = max(taps_t * st_t, taps_c * st_c) * np_ * 2, 2 * ldc
    n_slots, a0 = _ring((4 * w + xs_w) * row + in_rows * ldi * 2, slot)
    xs = a0 + 4 * w * row
    return dict(
        cp=cp, np=np_, ldc=ldc, cip=cip, ldi=ldi, w=w, xs_w=xs_w, n_fr=n_fr,
        in_rows=in_rows, step_rows_t=st_t, step_rows_c=st_c, taps_t=taps_t, taps_c=taps_c, slot_bytes=slot,
        n_slots=n_slots, bar=0, ring=TC_BAR_BYTES, a0=a0, a1=a0 + w * row,
        h=a0 + 2 * w * row, y=a0 + 3 * w * row, xs=xs, **{"in": xs + xs_w * row},
        bytes=xs + xs_w * row + in_rows * ldi * 2,
    )


def fused_smem_bytes_tc(c_in, c_out, u, nq, tile, halo, hpost) -> int:
    """Bytes of shared memory the bf16 body of fused_upsample_mrf.cu takes."""
    return fused_tc_layout(c_in, c_out, u, nq, tile, halo, hpost)["bytes"]


def fused_tc_fits(c_in, c_out, u, nq, tile, halo, hpost) -> bool:
    """Whether the bf16 body of fused_upsample_mrf runs this tile (its
    GEMMs span the window or the input frames)."""
    lay = fused_tc_layout(c_in, c_out, u, nq, tile, halo, hpost)
    return _layout_fits(lay, c_out, max(lay["w"], lay["n_fr"]))


TF32_PAD = 4  # floats past round16(C) in a float32 window row (tc_common.cuh: Elem<float>::kPad)


def _tf32_step_rows(k: int, n: int) -> int:
    """Input-channel rows of one float32 weight stage: 16 or 8, its hi and
    lo planes at most 16 KB together, dividing k
    (tc_common.cuh::tf32_step_rows)."""
    r = 16
    while r > 8 and (r * n * 8 > 16384 or k % r):
        r //= 2
    return r


def mrf_tf32_layout(c, tile, halo, rb1) -> Dict[str, int]:
    """Shared-memory layout of mrf_fused.cu's float32 body, in bytes,
    field by field as csrc/mrf_fused.cu::mrf_tf32_layout: the ring's
    mbarriers and weight stages (hi and lo planes), then position-major
    windows with rows of round16(C) + 4 floats for the residual stream
    and, for resblock "1", the inner conv output (w rows each), and the
    resblock sum (tile rows)."""
    cp = _r16(c)
    np_ = _npad(cp)
    ldc, w = cp + TF32_PAD, tile + 2 * halo
    step = _tf32_step_rows(cp, np_) if np_ else 8
    slot, row = 2 * step * np_ * 4, 4 * ldc
    n_slots, h = _ring(((2 if rb1 else 1) * w + tile) * row, slot)
    b = h + w * row
    xs = b + (w * row if rb1 else 0)
    return dict(
        cp=cp, np=np_, ldc=ldc, w=w, step_rows=step, taps=1, slot_bytes=slot, n_slots=n_slots,
        bar=0, ring=TC_BAR_BYTES, h=h, b=b, xs=xs, bytes=xs + tile * row,
    )


def mrf_tf32_fits(c, tile, halo, rb1) -> bool:
    """Whether the float32 body of mrf_fused runs this tile."""
    lay = mrf_tf32_layout(c, tile, halo, rb1)
    return _layout_fits(lay, c, lay["w"])


def fused_tf32_layout(c_in, c_out, u, nq, tile, halo, hpost, rb1) -> Dict[str, int]:
    """Shared-memory layout of fused_upsample_mrf.cu's float32 body, in
    bytes, field by field as csrc/fused_upsample_mrf.cu::tf32_layout: the
    ring's mbarriers and weight stages (hi and lo planes), then
    position-major windows with rows of round16(C) + 4 floats for the
    residual stream, resblock "1"'s inner output and the transposed conv's
    output (w rows each), the resblock sum (tile + 2 hpost rows) and the
    input frames (rows of round16(C_in) + 4 floats)."""
    cp, cip = _r16(c_out), _r16(c_in)
    np_ = _npad(cp)
    ldc, ldi = cp + TF32_PAD, cip + TF32_PAD
    w, xs_w = tile + 2 * halo, tile + 2 * hpost
    n_fr = (w + u - 2) // u + 1
    in_rows = n_fr + nq - 1
    st_t = _tf32_step_rows(cip, np_) if np_ else 8
    st_c = _tf32_step_rows(cp, np_) if np_ else 8
    slot, row = 2 * max(st_t, st_c) * np_ * 4, 4 * ldc
    n_slots, h = _ring(((3 if rb1 else 2) * w + xs_w) * row + in_rows * ldi * 4, slot)
    b = h + w * row
    y = b + (w * row if rb1 else 0)
    xs = y + w * row
    return dict(
        cp=cp, np=np_, ldc=ldc, cip=cip, ldi=ldi, w=w, xs_w=xs_w, n_fr=n_fr,
        in_rows=in_rows, step_rows_t=st_t, step_rows_c=st_c, taps_t=1, taps_c=1, slot_bytes=slot,
        n_slots=n_slots, bar=0, ring=TC_BAR_BYTES, h=h, b=b, y=y, xs=xs,
        **{"in": xs + xs_w * row}, bytes=xs + xs_w * row + in_rows * ldi * 4,
    )


def fused_tf32_fits(c_in, c_out, u, nq, tile, halo, hpost, rb1) -> bool:
    """Whether the float32 body of fused_upsample_mrf runs this tile."""
    lay = fused_tf32_layout(c_in, c_out, u, nq, tile, halo, hpost, rb1)
    return _layout_fits(lay, c_out, max(lay["w"], lay["n_fr"]))


def _chain_products(blocks, tile: int, chunks: int) -> int:
    """Warpgroup products on the busier warpgroup for the MRF chain of one
    block whose resblock sum spans `tile` rows: conv j of a resblock
    computes tile + 2 E rows (E = the reach of the convs after it)."""
    n = 0
    for steps in blocks:
        reach = sum((k * d - d) // 2 for k, d in steps)
        for k, d in steps:
            reach -= (k * d - d) // 2
            n += k * _per_group(tile + 2 * reach) * chunks
    return n


def _per_group(rows: int) -> int:
    """64-row output tiles of a GEMM over `rows` rows on the busier
    warpgroup."""
    return -(-(-(-rows // 64)) // TC_GROUPS)


def _pick_tile_by_cost(fits, cost, unit: int, n: int, rows: int, n_sm: int) -> int:
    """The tile (a multiple of `unit` that `fits`) with the least cost per
    SM over the grid: waves of one block per SM times `cost(tile)`, the
    products of one block on its busier warpgroup; the larger tile on a
    tie. 0 if none fits."""
    best, best_cost = 0, None
    for tile in range(unit, min(MAX_TILE, -(-n // unit) * unit) + 1, unit):
        if not fits(tile):
            continue
        c = -(-rows * -(-n // tile) // n_sm) * cost(tile)
        if best_cost is None or c <= best_cost:
            best, best_cost = tile, c
    return best


def mrf_fits(c, kernel_sizes, dilation_sizes, resblock_type, esize) -> bool:
    """Whether mrf_fused can run this stage with a tile of >= 32
    positions in shared memory."""
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    margin = _margin(kernel_sizes, dilation_sizes)
    return c % 4 == 0 and c <= 4 * THREADS and mrf_smem_bytes(
        c, 32, halo, margin, resblock_type == "1", esize
    ) <= SMEM_LIMIT


def fused_stage_fits(
    c_in, c_out, u, nq, kernel_sizes, dilation_sizes, resblock_type,
    u_in=1, post=True, esize=4,
) -> bool:
    """Whether fused_upsample_mrf can run this stage: at most 32 output
    planes (the TPU kernel's own cap, vocoder.py:750) and a tile of at
    least one frame (u*u_in samples, >= 32) in shared memory."""
    u_out = u * u_in
    if u_out > 32 or c_out % 4 or c_out > 4 * THREADS:
        return False
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    hpost = 3 if post else 0
    margin = _margin(kernel_sizes, dilation_sizes)
    tile = u_out * -(-32 // u_out)
    return fused_smem_bytes(
        c_in, c_out, u, nq, tile, halo + hpost, hpost, margin,
        resblock_type == "1", esize,
    ) <= SMEM_LIMIT


def _hashable(v):
    return tuple(_hashable(x) for x in v) if isinstance(v, (list, tuple)) else v


@functools.lru_cache(maxsize=1024)
def _mrf_tile_tc(b, c, t, kernel_sizes, dilation_sizes, resblock_type, n_sm, esize) -> int:
    """mrf_fused's tile: the one with the fewest warpgroup products per SM
    over the grid (multiples of 16 positions), in the bf16 layout (esize
    2) or the float32 one (esize 4: 8-channel units of three products)."""
    blocks, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    rb1 = resblock_type == "1"
    if esize == 2:
        fits, units = (lambda tl: mrf_tc_fits(c, tl, halo)), _r16(c) // 16
    else:
        fits, units = (lambda tl: mrf_tf32_fits(c, tl, halo, rb1)), 3 * _r16(c) // 8
    return _pick_tile_by_cost(fits, lambda tl: _chain_products(blocks, tl, units), 16, t, b, n_sm)


@functools.lru_cache(maxsize=1024)
def _fused_tile_tc(
    b, v, c_in, c_out, u, u_in, nq, hpost, kernel_sizes, dilation_sizes, resblock_type, n_sm, esize,
) -> int:
    """fused_upsample_mrf's tile (whole output frames, at least 16
    samples): the one with the fewest warpgroup products per SM over the
    grid, the transposed conv's (one GEMM per phase over the window's
    input frames, the phases' tiles dealt to the warpgroups in turn) and
    the chain's; in the bf16 layout (esize 2) or the float32 one (esize 4:
    8-channel units of three products)."""
    blocks, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    halo += hpost
    u_out = u * u_in
    rb1 = resblock_type == "1"

    def layout(tl):
        if esize == 2:
            return fused_tc_layout(c_in, c_out, u, nq, tl, halo, hpost)
        return fused_tf32_layout(c_in, c_out, u, nq, tl, halo, hpost, rb1)

    def fits(tl):
        lay = layout(tl)
        return _layout_fits(lay, c_out, max(lay["w"], lay["n_fr"]))

    per = 16 if esize == 2 else 8  # input channels of one unit
    mult = 1 if esize == 2 else 3  # products of one unit

    def cost(tl):
        lay = layout(tl)
        tconv = -(-u * -(-lay["n_fr"] // 64) // TC_GROUPS) * nq * mult * lay["cip"] // per
        return tconv + _chain_products(blocks, lay["xs_w"], mult * lay["cp"] // per)

    return _pick_tile_by_cost(fits, cost, u_out * -(-16 // u_out), v * u_out, b, n_sm)


def mrf_launch_config(
    b, c, t, kernel_sizes, dilation_sizes, resblock_type, k_max, esize, n_sm
) -> Dict[str, Any]:
    """Tile, halo, plan and shared-memory bytes of one mrf_fused launch
    (the arguments of csrc/mrf_fused.cu::pt_mrf_fused). esize 2 (bfloat16)
    sizes the bf16 body's layout, esize 4 the float32 body's."""
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    rb1 = resblock_type == "1"
    tile = _mrf_tile_tc(b, c, t, _hashable(kernel_sizes), _hashable(dilation_sizes), resblock_type, n_sm, esize)
    if tile == 0:
        raise ValueError(f"mrf_fused: C={c} with halo {halo} does not fit shared memory")
    lay = mrf_tc_layout(c, tile, halo) if esize == 2 else mrf_tf32_layout(c, tile, halo, rb1)
    return dict(
        tile=tile, halo=halo, smem=lay["bytes"],
        plan=mrf_plan_ints(kernel_sizes, dilation_sizes, resblock_type, k_max),
    )


def fused_launch_config(
    b, v, c_in, c_out, u, u_in, q0, nq, k_post, kernel_sizes, dilation_sizes,
    resblock_type, k_max, esize, n_sm,
) -> Dict[str, Any]:
    """Stage arguments, plan and shared-memory bytes of one
    fused_upsample_mrf launch (csrc/fused_upsample_mrf.cu::StageArgs).
    k_post = 0 means no conv_post. esize 2 (bfloat16) sizes the bf16
    body's layout, esize 4 the float32 body's."""
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    hpost = (k_post - 1) // 2 if k_post else 0
    halo += hpost
    rb1 = resblock_type == "1"
    tile = _fused_tile_tc(
        b, v, c_in, c_out, u, u_in, nq, hpost, _hashable(kernel_sizes),
        _hashable(dilation_sizes), resblock_type, n_sm, esize,
    )
    if tile == 0:
        raise ValueError("fused_upsample_mrf: this stage does not fit shared memory")
    if esize == 2:
        smem = fused_smem_bytes_tc(c_in, c_out, u, nq, tile, halo, hpost)
    else:
        smem = fused_tf32_layout(c_in, c_out, u, nq, tile, halo, hpost, rb1)["bytes"]
    args = [c_in, c_out, v, u, u_in, q0, nq, int(k_post > 0), k_post, tile, halo, hpost]
    return dict(
        args=args, tile=tile, smem=smem,
        plan=mrf_plan_ints(kernel_sizes, dilation_sizes, resblock_type, k_max),
    )


# ---------------------------------------------------------------------------
# Build and load (nvcc -> shared library with a plain C interface)
# ---------------------------------------------------------------------------

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, ctypes.CDLL]:
    """Compile (one nvcc per source, all at once) and load the kernels."""
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            with ThreadPoolExecutor(len(todo)) as pool:
                paths = dict(zip(todo, pool.map(_compile, todo)))
            for n in todo:
                lib = ctypes.CDLL(str(paths[n]))
                fn = getattr(lib, f"pt_{n}")
                fn.restype = ctypes.c_int
                if n == "mrf_fused":
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ]
                else:
                    fn.argtypes = [ctypes.c_void_p] * 8 + [
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ]
                _libs[n] = lib
    return {n: _libs[n] for n in names}


def _int_array(vals: Sequence[int]):
    return (ctypes.c_int * len(vals))(*vals)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc})")


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_count_lock = threading.Lock()
_recording = threading.local()


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` (a wrapper, or one of its LaunchCount
    by dtype). A read-modify-write of an attribute is not atomic across
    threads, so it runs under a lock. While this thread captures a CUDA
    graph (recording_launches), the launch is recorded for the graph
    instead: a capture runs nothing."""
    recorder = getattr(_recording, "counter", None)
    if recorder is not None:
        recorder[wrapper] += 1
        return
    with _count_lock:
        wrapper.launches += 1


class LaunchCount:
    """One dtype's launches of a wrapper (`wrapper.by_dtype[name]`)."""

    def __init__(self):
        self.launches = 0


def _count_by_dtype(wrapper) -> None:
    wrapper.launches = 0
    wrapper.by_dtype = {_dtype_name(dt): LaunchCount() for dt in _DTYPE_CODE}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


@contextlib.contextmanager
def recording_launches() -> Iterator[collections.Counter]:
    """Within it, this thread's kernel launches go into the yielded
    Counter (wrapper -> launches) instead of the wrappers' counts:
    runtime/graphs.py captures a graph inside it and adds the recorded
    launches to the counts at every replay."""
    recorder: collections.Counter = collections.Counter()
    _recording.counter = recorder
    try:
        yield recorder
    finally:
        _recording.counter = None


# ---------------------------------------------------------------------------
# The bf16 kernels' weight layout
# ---------------------------------------------------------------------------


def tc_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """Per-tap weight slices (..., K, N) -> the bf16 kernels' layout
    (..., Kp/8, Np/8, 8, 8): for each tap, K-major 8 x 8 core matrices
    (row n of a core matrix holds 8 consecutive input channels), core
    matrices along N 128 bytes apart and along K Np*16 bytes apart, as
    the wgmma matrix descriptor of csrc/tc_common.cuh::gemm reads them;
    K padded to a multiple of 16 and N to the product width
    (tc_common.cuh::npad) with zeros. A tap's slice, or any run of 16*j
    of its input channels, is one contiguous range: one bulk copy."""
    *lead, k, n = w.shape
    kp, np_ = _r16(k), _npad(_r16(n))
    if not np_:
        raise ValueError(f"the bf16 kernels take at most 256 output channels, got {n}")
    out = w.new_zeros((*lead, kp, np_))
    out[..., :k, :n] = w
    out = out.reshape(*lead, kp // 8, 8, np_ // 8, 8).transpose(-3, -2)  # (.., kb, nb, kk, nn)
    return out.transpose(-2, -1).contiguous()  # (.., kb, nb, nn, kk)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to tf32 as cvt.rna.tf32.f32 rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (the 13 bits
    below them zero); infinities and NaN as they are."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where((u & 0x7F800000) == 0x7F800000, u, r)
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of float32 x: hi = tf32(x), lo = tf32(x - hi), so
    hi + lo is x within about 2^-21 of |x| (tc_common.cuh::tf32_split)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """Per-tap float32 weight slices (..., K, N) -> the float32 kernels'
    layout (2, ..., Kp/4, Np/8, 8, 4): the 3xTF32 hi plane, then the lo
    plane (tf32_split), each for each tap in K-major core matrices of 8
    rows x 16 bytes (row n of a core matrix holds 4 consecutive input
    channels), core matrices along N 128 bytes apart and along K Np*16
    bytes apart, as the wgmma matrix descriptor of csrc/tc_common.cuh::
    gemm reads them; K padded to a multiple of 16 and N to the product
    width with zeros. A tap's slice, or any run of 8*j of its input
    channels, is one contiguous range of each plane: one bulk copy each."""
    *lead, k, n = w.shape
    kp, np_ = _r16(k), _npad(_r16(n))
    if not np_:
        raise ValueError(f"the float32 kernels take at most 256 output channels, got {n}")
    out = w.new_zeros((*lead, kp, np_), dtype=torch.float32)
    out[..., :k, :n] = w
    planes = torch.stack(tf32_split(out))
    planes = planes.reshape(2, *lead, kp // 4, 4, np_ // 8, 8).transpose(-3, -2)  # (.., kb, nb, kk, nn)
    return planes.transpose(-2, -1).contiguous()  # (2, .., kb, nb, nn, kk)


def kernel_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """The kernel layout of w's dtype: tc_weight_layout (bf16) or
    tf32_weight_layout (float32)."""
    return tc_weight_layout(w) if w.dtype == torch.bfloat16 else tf32_weight_layout(w)


_tc_cache: Dict[int, Tuple[Any, int, int, torch.Tensor]] = {}
_tc_lock = threading.Lock()


def _version(w: torch.Tensor) -> Optional[int]:
    """w's version counter, or None for an inference tensor (made in
    torch.inference_mode, which keeps no version counter for it)."""
    return None if w.is_inference() else w._version


def tc_weights(w: torch.Tensor) -> torch.Tensor:
    """kernel_weight_layout(w), made once per weight tensor (again if w is
    modified in place, except an inference tensor's, which PyTorch keeps
    no version of) and kept while w lives; its address and every slice a
    bulk copy takes of it (taps, and the steps and stages cut from them:
    multiples of 16 bf16 or 8 float input channels) are checked on 16
    bytes when it is made. prepare_tm makes it for a voice's weights, so a
    call inside a CUDA graph capture finds it made; making it there would
    record the repacking in the graph, so that raises."""
    key = id(w)
    with _tc_lock:
        hit = _tc_cache.get(key)
    if hit is not None and hit[0]() is w and hit[1] == _version(w) and hit[2] == w.data_ptr():
        return hit[3]
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the kernels' weight layout is made before a CUDA graph capture (prepare_tm)")
    out = kernel_weight_layout(w)
    _check_bulk(out, (out.shape[-4] * out.shape[-3] * 128, out.shape[-3] * 256), "tc_weights")
    ref = weakref.ref(w, lambda _, key=key: _tc_cache.pop(key, None))
    with _tc_lock:
        _tc_cache[key] = (ref, _version(w), w.data_ptr(), out)
    return out


def _check_bulk(t: torch.Tensor, slice_bytes: Sequence[int], name: str) -> None:
    """The bulk copies need 16-byte addresses and sizes."""
    if t.data_ptr() % 16 or any(b % 16 for b in slice_bytes):
        raise ValueError(f"{name}: the kernels' bulk copies need 16-byte aligned weights and slices")


# ---------------------------------------------------------------------------
# mrf_fused
# ---------------------------------------------------------------------------


def mrf_fused(
    x_tm: torch.Tensor,  # (B, C, T) time-major
    lengths: torch.Tensor,  # (B,) int32 valid samples
    packed_w: torch.Tensor,  # (n_convs, k_max, C, C)
    packed_b: torch.Tensor,  # (n_convs, C, 1) float32
    *,
    kernel_sizes: Tuple[int, ...],
    dilation_sizes: Tuple[Tuple[int, ...], ...],
    resblock_type: str,
) -> torch.Tensor:
    """Fused MRF stage: returns the mean of resblocks, (B, C, T)."""
    if x_tm.device.type == "cpu":
        return mrf_fused_plain(
            x_tm, lengths, packed_w, packed_b, kernel_sizes=kernel_sizes,
            dilation_sizes=dilation_sizes, resblock_type=resblock_type,
        )
    if x_tm.device.type != "cuda":
        raise ValueError(f"mrf_fused runs on cuda or cpu, not {x_tm.device}")
    b, c, t = x_tm.shape
    dev, dt = x_tm.device, x_tm.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"mrf_fused takes float32 or bfloat16, not {dt}")
    n_convs, k_max = packed_w.shape[:2]
    plan = mrf_plan_ints(kernel_sizes, dilation_sizes, resblock_type, k_max)
    if sum(plan[3 : 3 + plan[0]]) != n_convs:
        raise ValueError("packed weights do not match the stage plan")
    _check(x_tm, "x_tm", dt, (b, c, t), dev)
    _check(lengths, "lengths", torch.int32, (b,), dev)
    _check(packed_w, "packed_w", dt, (n_convs, k_max, c, c), dev)
    _check(packed_b, "packed_b", torch.float32, (n_convs, c, 1), dev)
    if c % 4 or c > 4 * THREADS:
        raise ValueError(f"mrf_fused needs C % 4 == 0 and C <= {4 * THREADS}, got {c}")
    cfg = mrf_launch_config(
        b, c, t, kernel_sizes, dilation_sizes, resblock_type, k_max,
        x_tm.element_size(), _n_sm(dev),
    )
    w_arg = tc_weights(packed_w)
    fn = build(["mrf_fused"])["mrf_fused"].pt_mrf_fused
    out = torch.empty_like(x_tm)
    if t == 0 or b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(
            x_tm.data_ptr(), lengths.data_ptr(), w_arg.data_ptr(),
            packed_b.data_ptr(), out.data_ptr(), b, c, t, cfg["tile"],
            cfg["halo"], _DTYPE_CODE[dt],
            _int_array(cfg["plan"]), len(cfg["plan"]), cfg["smem"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "mrf_fused")
    count_launch(mrf_fused)
    count_launch(mrf_fused.by_dtype[_dtype_name(dt)])
    return out


_count_by_dtype(mrf_fused)


# Time tile of the plain versions' products: each product runs over
# fixed tiles of this many samples (the last one zero-padded), so an
# output sample's sum order does not depend on the row's width or on the
# batch, as in the kernels (CPU BLAS picks its blocking by the product's
# shape). A row then gives the same bits at any padded width.
PLAIN_TILE = 256


def _tiled_product(w2: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(O, K) float32 weights times (B, K, T) float32 columns ->
    (B, O, T), over fixed PLAIN_TILE-sample tiles of T."""
    b, k, t = cols.shape
    nt = -(-t // PLAIN_TILE)
    c = F.pad(cols, (0, nt * PLAIN_TILE - t)).reshape(b, k, nt, PLAIN_TILE).permute(0, 2, 1, 3)
    out = torch.matmul(w2, c)  # (B, nt, O, TILE)
    return out.permute(0, 2, 1, 3).reshape(b, w2.shape[0], nt * PLAIN_TILE)[..., :t]


def _conv_taps(h, w_taps, bias, k: int, d: int) -> torch.Tensor:
    """Dilated "same" conv as ONE tap-packed product (the kernel's and the
    TPU kernel's arithmetic): the k shifted copies of h are stacked and
    contracted over (tap, C_in) in float32, bias added, then rounded to
    h's dtype. h: (B, C_in, T); w_taps: (k, C_in, C_out)."""
    pad = (k * d - d) // 2
    b, c, t = h.shape
    hp = F.pad(h.float(), (pad, pad))
    stacked = torch.stack([hp[:, :, kk * d : kk * d + t] for kk in range(k)], 1)
    acc = _tiled_product(w_taps.float().reshape(k * c, -1).t(), stacked.reshape(b, k * c, t))
    return (acc + bias.float().reshape(1, -1, 1)).to(h.dtype)


def _where(valid, v):
    return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))


def mrf_fused_plain(
    x_tm: torch.Tensor,
    lengths: torch.Tensor,
    packed_w: torch.Tensor,
    packed_b: torch.Tensor,
    *,
    kernel_sizes: Tuple[int, ...],
    dilation_sizes: Tuple[Tuple[int, ...], ...],
    resblock_type: str,
) -> torch.Tensor:
    """Plain PyTorch version of mrf_fused (same signature and layout)."""
    blocks, _ = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    t = x_tm.shape[-1]
    valid = (
        torch.arange(t, device=x_tm.device)[None, :] < lengths.to(x_tm.device)[:, None]
    )[:, None, :]
    x = _where(valid, x_tm)
    conv = 0
    xs = None
    for steps in blocks:
        h = x
        group = 2 if resblock_type == "1" else 1
        for i in range(0, len(steps), group):
            ht = h
            for k, d in steps[i : i + group]:
                ht = _where(valid, F.leaky_relu(ht, LRELU_SLOPE))
                ht = _conv_taps(ht, packed_w[conv, :k], packed_b[conv, :, 0], k, d)
                conv += 1
            h = ht + h
        h = _where(valid, h)
        xs = h if xs is None else xs + h
    return xs / len(blocks)


# ---------------------------------------------------------------------------
# fused_upsample_mrf
# ---------------------------------------------------------------------------


def fused_upsample_mrf(
    x_tm: torch.Tensor,  # (B, u_in*C_in, V) stage input (pre-lrelu)
    lengths: torch.Tensor,  # (B,) int32 valid OUTPUT samples of this stage
    wt: torch.Tensor,  # (u, nq, C_in, C_out) polyphase taps (zeros unused)
    bt: torch.Tensor,  # (C_out,) tconv bias
    wm: torch.Tensor,  # (n_convs, k_max, C_out, C_out) packed MRF weights
    bm: torch.Tensor,  # (n_convs, C_out, 1) MRF biases
    wpost: Optional[torch.Tensor],  # (k_post, C_out, 1) conv_post or None
    *,
    u: int,
    u_in: int = 1,
    q0: int,
    kernel_sizes: Tuple[int, ...],
    dilation_sizes: Tuple[Tuple[int, ...], ...],
    resblock_type: str,
    post: bool = False,
) -> torch.Tensor:
    """One HiFiGAN upsample stage in a single kernel.

    Input: interleaved time-major (u_in=1, V = input samples) or the
    phase-plane output of a previous fused stage (u_in>1, rows =
    u_in*C_in plane-major, V = frames; zero past each row's length, as
    fused-stage outputs are). With u_out = u*u_in:
    - post=True: returns (B, u_out, V) waveform planes;
    - post=False: returns (B, u_out*C_out, V) planes for the next stage.
    """
    args = dict(
        u=u, u_in=u_in, q0=q0, kernel_sizes=kernel_sizes,
        dilation_sizes=dilation_sizes, resblock_type=resblock_type, post=post,
    )
    if x_tm.device.type == "cpu":
        return fused_upsample_mrf_plain(x_tm, lengths, wt, bt, wm, bm, wpost, **args)
    if x_tm.device.type != "cuda":
        raise ValueError(f"fused_upsample_mrf runs on cuda or cpu, not {x_tm.device}")
    b, rows_in, v = x_tm.shape
    dev, dt = x_tm.device, x_tm.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused_upsample_mrf takes float32 or bfloat16, not {dt}")
    _, nq, c_in, c_out = wt.shape
    if rows_in != u_in * c_in:
        raise ValueError(f"x_tm has {rows_in} rows, expected u_in*C_in = {u_in * c_in}")
    n_convs, k_max = wm.shape[:2]
    plan = mrf_plan_ints(kernel_sizes, dilation_sizes, resblock_type, k_max)
    if sum(plan[3 : 3 + plan[0]]) != n_convs:
        raise ValueError("packed weights do not match the stage plan")
    _check(x_tm, "x_tm", dt, (b, rows_in, v), dev)
    _check(lengths, "lengths", torch.int32, (b,), dev)
    _check(wt, "wt", dt, (u, nq, c_in, c_out), dev)
    _check(bt, "bt", torch.float32, (c_out,), dev)
    _check(wm, "wm", dt, (n_convs, k_max, c_out, c_out), dev)
    _check(bm, "bm", torch.float32, (n_convs, c_out, 1), dev)
    if c_out % 4 or c_out > 4 * THREADS:
        raise ValueError(
            f"fused_upsample_mrf needs C_out % 4 == 0 and C_out <= {4 * THREADS}"
        )
    k_post = 0
    if post:
        if wpost is None:
            raise ValueError("post=True needs wpost")
        k_post = wpost.shape[0]
        _check(wpost, "wpost", dt, (k_post, c_out, 1), dev)
    cfg = fused_launch_config(
        b, v, c_in, c_out, u, u_in, q0, nq, k_post, kernel_sizes,
        dilation_sizes, resblock_type, k_max, x_tm.element_size(), _n_sm(dev),
    )
    wt_arg, wm_arg = tc_weights(wt), tc_weights(wm)
    fn = build(["fused_upsample_mrf"])["fused_upsample_mrf"].pt_fused_upsample_mrf
    out = torch.empty(
        (b, u * u_in if post else u * u_in * c_out, v), dtype=dt, device=dev
    )
    if v == 0 or b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(
            x_tm.data_ptr(), lengths.data_ptr(), wt_arg.data_ptr(), bt.data_ptr(),
            wm_arg.data_ptr(), bm.data_ptr(), wpost.data_ptr() if post else None,
            out.data_ptr(), b, _int_array(cfg["args"]), len(cfg["args"]),
            _DTYPE_CODE[dt], _int_array(cfg["plan"]), len(cfg["plan"]),
            cfg["smem"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "fused_upsample_mrf")
    count_launch(fused_upsample_mrf)
    count_launch(fused_upsample_mrf.by_dtype[_dtype_name(dt)])
    return out


_count_by_dtype(fused_upsample_mrf)


def fused_upsample_mrf_plain(
    x_tm: torch.Tensor,
    lengths: torch.Tensor,
    wt: torch.Tensor,
    bt: torch.Tensor,
    wm: torch.Tensor,
    bm: torch.Tensor,
    wpost: Optional[torch.Tensor],
    *,
    u: int,
    u_in: int = 1,
    q0: int,
    kernel_sizes: Tuple[int, ...],
    dilation_sizes: Tuple[Tuple[int, ...], ...],
    resblock_type: str,
    post: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of fused_upsample_mrf (same signature and
    output layout), in interleaved true time."""
    b, _, v = x_tm.shape
    _, nq, c_in, c_out = wt.shape
    dev, dt = x_tm.device, x_tm.dtype
    u_out = u * u_in
    lengths = lengths.to(dev).long()
    # planes -> true time: row p*C_in + c, frame f holds sample u_in*f + p
    x = x_tm.reshape(b, u_in, c_in, v).permute(0, 2, 3, 1).reshape(b, c_in, v * u_in)
    n_in, n_out = v * u_in, v * u_out
    in_len = (lengths // u).clamp(max=n_in)
    x = _where((torch.arange(n_in, device=dev)[None, :] < in_len[:, None])[:, None], x)
    x = F.leaky_relu(x, LRELU_SLOPE).float()
    # polyphase transposed conv: y[u*s + p] = bt + sum_q wt[p, q]^T x[s + q0 + q]
    segs = []
    for qi in range(nq):
        q = q0 + qi
        seg = F.pad(x, (max(-q, 0), max(q, 0)))
        segs.append(seg[:, :, max(q, 0) : max(q, 0) + n_in])
    taps = torch.stack(segs, 1).reshape(b, nq * c_in, n_in)  # (B, nq*C_in, n_in)
    w2 = wt.float().permute(0, 3, 1, 2).reshape(u * c_out, nq * c_in)  # rows (p, o)
    y = _tiled_product(w2, taps).reshape(b, u, c_out, n_in).permute(0, 2, 3, 1)
    y = y.reshape(b, c_out, n_out)
    y = (y + bt.float().reshape(1, -1, 1)).to(dt)
    len_out = lengths.clamp(max=n_out)
    valid = (torch.arange(n_out, device=dev)[None, :] < len_out[:, None])[:, None]
    y = _where(valid, y)
    y = mrf_fused_plain(
        y, len_out, wm, bm, kernel_sizes=kernel_sizes,
        dilation_sizes=dilation_sizes, resblock_type=resblock_type,
    )
    if not post:
        return y.reshape(b, c_out, v, u_out).permute(0, 3, 1, 2).reshape(
            b, u_out * c_out, v
        )
    # conv_post (k taps, C -> 1, no bias) in float32, then tanh
    kp = wpost.shape[0]
    g = F.pad(_where(valid, F.leaky_relu(y, 0.01)).float(), ((kp - 1) // 2,) * 2)
    stacked = torch.stack([g[:, :, kk : kk + n_out] for kk in range(kp)], 1)
    acc = _tiled_product(wpost.float().reshape(1, kp * c_out), stacked.reshape(b, kp * c_out, n_out))[:, 0]
    wave = _where(valid[:, 0], torch.tanh(acc)).to(dt)
    return wave.reshape(b, v, u_out).permute(0, 2, 1).contiguous()

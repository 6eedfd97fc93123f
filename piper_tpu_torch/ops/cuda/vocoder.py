"""The HiFiGAN vocoder kernels: CUDA C++ for Hopper, and their plain versions.

Counterpart of piper_tpu/ops/pallas/vocoder.py. Its two Pallas TPU
kernels become hand-written CUDA kernels (csrc/mrf_fused.cu,
csrc/fused_upsample_mrf.cu), built with nvcc for sm_90a at first use
into build/piper_tpu_torch/ at the checkout root, and bound with ctypes
through a plain C interface.

  mrf_fused            one MRF stage (resblock stack, mean), time-major
  fused_upsample_mrf   lrelu -> polyphase ConvTranspose1d -> MRF
                       [-> conv_post -> tanh], phase-plane layouts

Each kernel has two bodies: float32 (parity) on the CUDA cores, and
bfloat16 (serving) on the tensor cores (mma.sync, csrc/tc_common.cuh).
The bf16 bodies' tiles come from their shared-memory layouts, mirrored
here: mrf_smem_bytes_tc / mrf_tc_fits (mrf_fused.cu::mrf_tc_layout) and
fused_smem_bytes_tc / fused_tc_fits (fused_upsample_mrf.cu::tc_layout).

Each wrapper takes its plain PyTorch version (`*_plain`, same signature
and output layout) only when the input lies on the CPU. For a CUDA
tensor it launches the kernel or raises; a failed build raises too.
Each wrapper counts its kernel launches in a plain integer attribute
(`mrf_fused.launches`, `fused_upsample_mrf.launches`), bumped under a
lock (`count_launch`) so the counts stay exact when several threads
launch (a server's request handlers, its batcher, a background warm-up).
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
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
THREADS = 256  # threads per block (csrc/mrf_common.cuh: kThreads)
TC_TILES = 8 * 12  # (16-row, 16-column) GEMM tiles a block holds (kWarps * kMI)
MRF_TC_STEP_ROWS = 64  # weight rows mrf_fused's bf16 body stages per GEMM step (kStepRows)
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
    """Bytes of shared memory mrf_fused.cu's block layout takes."""
    w = tile + 2 * halo
    n = _al(c * (w + 2 * margin)) + _al(c * w) * (2 if rb1 else 1) + _al(c * tile)
    return n * esize


def fused_smem_bytes(c_in, c_out, u, nq, tile, halo, hpost, margin, rb1, esize) -> int:
    """Bytes of shared memory fused_upsample_mrf.cu's block layout takes."""
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


def fused_smem_bytes_tc(c_in, c_out, u, nq, tile, halo, hpost) -> int:
    """Bytes of shared memory the bf16 tensor-core body of
    fused_upsample_mrf.cu takes (csrc/fused_upsample_mrf.cu::tc_layout):
    position-major rows of round16(C) + 8 bf16 for the two conv inputs
    (+16 rows each), the residual stream, the transposed conv's output and
    the resblock sum; the input window; two whole-tap weight buffers."""
    ldc, ldi = _r16(c_out) + 8, _r16(c_in) + 8
    w = tile + 2 * halo
    n_fr = (w + u - 2) // u + 1
    n = (
        ldc * (2 * (w + 16) + 2 * w + tile + 2 * hpost)
        + ldi * (_r16(n_fr) + nq)
        + 2 * max(_r16(c_in), _r16(c_out)) * ldc
    )
    return 2 * n


def fused_tc_fits(c_in, c_out, u, nq, tile, halo, hpost) -> bool:
    """Whether the bf16 body runs this tile: its layout fits shared memory
    and each GEMM's (16-row, 16-column) tiles fit the block's warps."""
    w = tile + 2 * halo
    return (
        -(-w // 16) * (_r16(c_out) // 16) <= TC_TILES
        and fused_smem_bytes_tc(c_in, c_out, u, nq, tile, halo, hpost) <= SMEM_LIMIT
    )


def mrf_smem_bytes_tc(c, tile, halo) -> int:
    """Bytes of shared memory the bf16 tensor-core body of mrf_fused.cu
    takes (csrc/mrf_fused.cu::mrf_tc_layout): position-major rows of
    round16(C) + 8 bf16 for the two conv inputs (+16 rows each), the
    residual stream and the resblock sum; two weight buffers of up to 64
    input channels of one tap."""
    ldc = _r16(c) + 8
    w = tile + 2 * halo
    return 2 * ldc * (2 * (w + 16) + w + tile + 2 * min(MRF_TC_STEP_ROWS, _r16(c)))


def mrf_tc_fits(c, tile, halo) -> bool:
    """Whether the bf16 body of mrf_fused runs this tile: its layout fits
    shared memory and each GEMM's (16-row, 16-column) tiles fit the
    block's warps."""
    w = tile + 2 * halo
    return (
        -(-w // 16) * (_r16(c) // 16) <= TC_TILES
        and mrf_smem_bytes_tc(c, tile, halo) <= SMEM_LIMIT
    )


def _pick_tile(fits, unit: int, n: int, rows: int, n_sm: int) -> int:
    """Largest tile (a multiple of `unit`) that `fits`, then halved while
    the grid would leave SMs idle. 0 if none fits."""
    tile = min(MAX_TILE, -(-n // unit) * unit)
    while tile >= unit and not fits(tile):
        tile -= unit
    if tile < unit:
        return 0
    floor = max(unit, 64)
    while rows * -(-n // tile) < 2 * n_sm:
        half = -(-(tile // 2) // unit) * unit
        if half < floor or half >= tile:
            break
        tile = half
    return tile


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


def mrf_launch_config(
    b, c, t, kernel_sizes, dilation_sizes, resblock_type, k_max, esize, n_sm
) -> Dict[str, Any]:
    """Tile, halo, margin, plan and shared-memory bytes of one mrf_fused
    launch (the arguments of csrc/mrf_fused.cu::pt_mrf_fused). esize 2
    (bfloat16) sizes the tensor-core body's layout, esize 4 the float32
    CUDA-core body's."""
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    margin = _margin(kernel_sizes, dilation_sizes)
    rb1 = resblock_type == "1"

    if esize == 2:
        def smem(tl):
            return mrf_smem_bytes_tc(c, tl, halo)

        def fits(tl):
            return mrf_tc_fits(c, tl, halo)
    else:
        def smem(tl):
            return mrf_smem_bytes(c, tl, halo, margin, rb1, esize)

        def fits(tl):
            return smem(tl) <= SMEM_LIMIT

    tile = _pick_tile(fits, 16, t, b, n_sm)
    if tile == 0:
        raise ValueError(f"mrf_fused: C={c} with halo {halo} does not fit shared memory")
    return dict(
        tile=tile, halo=halo, margin=margin, smem=smem(tile),
        plan=mrf_plan_ints(kernel_sizes, dilation_sizes, resblock_type, k_max),
    )


def fused_launch_config(
    b, v, c_in, c_out, u, u_in, q0, nq, k_post, kernel_sizes, dilation_sizes,
    resblock_type, k_max, esize, n_sm,
) -> Dict[str, Any]:
    """Stage arguments, plan and shared-memory bytes of one
    fused_upsample_mrf launch (csrc/fused_upsample_mrf.cu::StageArgs).
    k_post = 0 means no conv_post. esize 2 (bfloat16) sizes the
    tensor-core body's layout, esize 4 the float32 CUDA-core body's."""
    _, halo = stage_plan(kernel_sizes, dilation_sizes, resblock_type)
    hpost = (k_post - 1) // 2 if k_post else 0
    halo += hpost
    margin = _margin(kernel_sizes, dilation_sizes)
    u_out = u * u_in
    rb1 = resblock_type == "1"

    if esize == 2:
        def smem(tl):
            return fused_smem_bytes_tc(c_in, c_out, u, nq, tl, halo, hpost)

        def fits(tl):
            return fused_tc_fits(c_in, c_out, u, nq, tl, halo, hpost)
    else:
        def smem(tl):
            return fused_smem_bytes(c_in, c_out, u, nq, tl, halo, hpost, margin, rb1, esize)

        def fits(tl):
            return smem(tl) <= SMEM_LIMIT

    tile = _pick_tile(fits, u_out * -(-16 // u_out), v * u_out, b, n_sm)
    if tile == 0:
        raise ValueError("fused_upsample_mrf: this stage does not fit shared memory")
    args = [
        c_in, c_out, v, u, u_in, q0, nq, int(k_post > 0), k_post, tile, halo,
        hpost, margin, _ld_in(tile + 2 * halo, u, nq),
    ]
    return dict(
        args=args, tile=tile, smem=smem(tile),
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
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
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
    """Add one to `wrapper.launches`. A read-modify-write of an attribute
    is not atomic across threads, so it runs under a lock. While this
    thread captures a CUDA graph (recording_launches), the launch is
    recorded for the graph instead: a capture runs nothing."""
    recorder = getattr(_recording, "counter", None)
    if recorder is not None:
        recorder[wrapper] += 1
        return
    with _count_lock:
        wrapper.launches += 1


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
    if dt == torch.bfloat16 and packed_w.data_ptr() % 16:
        raise ValueError("mrf_fused (bf16) needs packed_w on a 16-byte boundary")
    cfg = mrf_launch_config(
        b, c, t, kernel_sizes, dilation_sizes, resblock_type, k_max,
        x_tm.element_size(), _n_sm(dev),
    )
    fn = build(["mrf_fused"])["mrf_fused"].pt_mrf_fused
    out = torch.empty_like(x_tm)
    if t == 0 or b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(
            x_tm.data_ptr(), lengths.data_ptr(), packed_w.data_ptr(),
            packed_b.data_ptr(), out.data_ptr(), b, c, t, cfg["tile"],
            cfg["halo"], cfg["margin"], _DTYPE_CODE[dt],
            _int_array(cfg["plan"]), len(cfg["plan"]), cfg["smem"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "mrf_fused")
    count_launch(mrf_fused)
    return out


mrf_fused.launches = 0


def _conv_taps(h, w_taps, bias, k: int, d: int) -> torch.Tensor:
    """Dilated "same" conv as ONE tap-packed product (the kernel's and the
    TPU kernel's arithmetic): the k shifted copies of h are stacked and
    contracted over (tap, C_in) in float32, bias added, then rounded to
    h's dtype. h: (B, C_in, T); w_taps: (k, C_in, C_out)."""
    pad = (k * d - d) // 2
    t = h.shape[-1]
    hp = F.pad(h.float(), (pad, pad))
    stacked = torch.stack([hp[:, :, kk * d : kk * d + t] for kk in range(k)], 1)
    acc = torch.einsum("kio,bkit->bot", w_taps.float(), stacked)
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
    if dt == torch.bfloat16 and (wt.data_ptr() % 16 or wm.data_ptr() % 16):
        raise ValueError("fused_upsample_mrf (bf16) needs wt and wm on 16-byte boundaries")
    cfg = fused_launch_config(
        b, v, c_in, c_out, u, u_in, q0, nq, k_post, kernel_sizes,
        dilation_sizes, resblock_type, k_max, x_tm.element_size(), _n_sm(dev),
    )
    fn = build(["fused_upsample_mrf"])["fused_upsample_mrf"].pt_fused_upsample_mrf
    out = torch.empty(
        (b, u * u_in if post else u * u_in * c_out, v), dtype=dt, device=dev
    )
    if v == 0 or b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(
            x_tm.data_ptr(), lengths.data_ptr(), wt.data_ptr(), bt.data_ptr(),
            wm.data_ptr(), bm.data_ptr(), wpost.data_ptr() if post else None,
            out.data_ptr(), b, _int_array(cfg["args"]), len(cfg["args"]),
            _DTYPE_CODE[dt], _int_array(cfg["plan"]), len(cfg["plan"]),
            cfg["smem"], torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "fused_upsample_mrf")
    count_launch(fused_upsample_mrf)
    return out


fused_upsample_mrf.launches = 0


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
    taps = torch.stack(segs, 1)  # (B, nq, C_in, n_in)
    y = torch.einsum("pqio,bqis->bosp", wt.float(), taps).reshape(b, c_out, n_out)
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
    g = F.pad(_where(valid, F.leaky_relu(y, 0.01)).float(), ((wpost.shape[0] - 1) // 2,) * 2)
    acc = sum(
        torch.einsum("c,bct->bt", wpost[kk, :, 0].float(), g[:, :, kk : kk + n_out])
        for kk in range(wpost.shape[0])
    )
    wave = _where(valid[:, 0], torch.tanh(acc)).to(dt)
    return wave.reshape(b, v, u_out).permute(0, 2, 1).contiguous()

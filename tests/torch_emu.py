"""Build and bind the host emulation of the CUDA kernels (csrc/host_emulation.cpp).

g++ compiles mrf_fused.cu and fused_upsample_mrf.cu with
-DPT_HOST_EMULATION; tests call its entry points through ctypes on CPU
tensors (tests/test_torch_kernel_emulation.py, test_torch_wgmma_emulation.py,
test_torch_launch_config.py, test_torch_tf32_emulation.py).
"""

import ctypes
import shutil
import subprocess

import pytest

from piper_tpu_torch.ops.cuda import vocoder as V


def build_emulation(out_dir, csrc=V.CSRC) -> ctypes.CDLL:
    """Build csrc/host_emulation.cpp (or the one in another copy of
    csrc/) into out_dir and bind its entry points."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the emulation")
    out = out_dir / "libemu.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-DPT_HOST_EMULATION",
         str(csrc / "host_emulation.cpp"), "-o", str(out)],
        check=True, capture_output=True,
    )
    return bind_emulation(out)


def bind_emulation(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.emu_mrf_fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.emu_fused_upsample_mrf.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.emu_fault.restype = ctypes.c_char_p
    lib.emu_mrf_tc_layout.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.emu_fused_tc_layout.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.emu_mrf_tf32_layout.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.emu_fused_tf32_layout.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.emu_tf32_probe.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.emu_tf32_split.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.emu_wgmma_probe.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib

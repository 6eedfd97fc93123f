"""Build and bind the host emulation of the CUDA kernels (csrc/host_emulation.cpp).

g++ compiles mrf_fused.cu and fused_upsample_mrf.cu with
-DPT_HOST_EMULATION; tests call its entry points through ctypes on CPU
tensors (tests/test_torch_kernel_emulation.py, test_torch_wgmma_emulation.py,
test_torch_launch_config.py).
"""

import ctypes
import shutil
import subprocess

import pytest

from piper_tpu_torch.ops.cuda import vocoder as V


def build_emulation(out_dir) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build the emulation")
    out = out_dir / "libemu.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-DPT_HOST_EMULATION",
         str(V.CSRC / "host_emulation.cpp"), "-o", str(out)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(out))
    lib.emu_mrf_fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.emu_fused_upsample_mrf.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.emu_fault.restype = ctypes.c_char_p
    lib.emu_mrf_tc_layout.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.emu_fused_tc_layout.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.emu_wgmma_probe.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib

"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version. ``build`` compiles and binds them at first use."""
import contextlib

import torch


def exact_cuda_math() -> None:
    """Full-f32 reference math on the card for the plain versions: no TF32
    in cuDNN convolutions or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def f32_matmul():
    """Full-f32 matmuls (no TF32) inside the block only; the process's
    setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)

"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version. ``build`` compiles and binds them at first use."""
import torch


def exact_cuda_math() -> None:
    """Full-f32 reference math on the card for the plain versions: no TF32
    in cuDNN convolutions or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): the denominators of every
roofline share and utilization the benchmark reports. The card's power
limit is read in each run and printed beside them."""

PEAKS = {
    "bf16_tensor_flops": 989e12,   # bf16 / fp16 on the tensor cores
    "f32_flops": 67e12,            # float32 on the CUDA cores
    "hbm_bytes_per_s": 3.35e12,    # HBM3
}

"""Published peaks of the chips the benchmark runs on (NVIDIA's data sheet,
H100 SXM, dense rates without sparsity, at the full 700 W). A share of a
roofline is stated against these, with the card's power limit beside it."""

H100 = {
    "bf16_flops": 989e12,
    "fp16_flops": 989e12,
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def for_device(name: str) -> dict:
    if "H100" in name:
        return H100
    raise KeyError(f"no table of peaks for {name!r}")


def roofline_share(flops: float, nbytes: float, seconds: float, peaks: dict, flops_key: str):
    """(percent of the roofline reached, the bound: "flops" or "bytes")."""
    t_flops = flops / peaks[flops_key]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    bound = "flops" if t_flops >= t_bytes else "bytes"
    return 100.0 * max(t_flops, t_bytes) / seconds, bound

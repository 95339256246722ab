"""`dense_copy_link_pct`: the host-to-device copies' share of the host
link in the profiled calls. Work: the calls' input, which any feed has to
move (cells x genes x 4 bytes a call, the cell's `input_bytes_per_call`;
pad rows are not counted). Time: the device seconds of the host-to-device
copies among the card-only trace's leading device operations (where the
feed's copies lead the call's device time, as at the cell's size). Against
the H100's PCIe 5.0 x16 host link, one way."""

# NVIDIA's H100 data sheet: PCIe Gen5, 128 GB/s both ways
LINK_BYTES_PER_S = 64e9


def _is_htod(name: str) -> bool:
    return "HtoD" in name or "Host -> Device" in name


def read(ctx):
    per_call = getattr(ctx, "input_bytes_per_call", None)
    if not ctx.trace or not ctx.profiled or per_call is None:
        return None
    seconds = sum(s for name, s in ctx.trace.device_ops if _is_htod(name))
    if not seconds:
        return None
    return 100.0 * per_call * len(ctx.profiled) / seconds / LINK_BYTES_PER_S

KERNEL_WRAPPERS = ("expand_fields", "rasterize_tiles", "tile_loss_tiles",
                   "rasterize_tiles_backward", "segment_sum_rows",
                   "entry_counts")


def kernel_launches() -> dict:
    """The launch count of every kernel wrapper in this process (the
    tracer's ``launches.<wrapper>`` counters)."""
    from webdgs_tpu_torch import trace
    c = trace.counters()
    return {k: c.get("launches." + k, 0) for k in KERNEL_WRAPPERS}

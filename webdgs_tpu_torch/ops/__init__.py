def kernel_launches() -> dict:
    """The launch count of every kernel wrapper in this process."""
    from webdgs_tpu_torch.ops import (expand, importance, rasterize, segsum,
                                      tile_loss)
    return {f.__name__: f.kernel_launches for f in (
        expand.expand_fields, rasterize.rasterize_tiles,
        tile_loss.tile_loss_tiles, rasterize.rasterize_tiles_backward,
        segsum.segment_sum_rows, importance.entry_counts)}

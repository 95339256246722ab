from sharp_tpu_torch.io.blocks import BlockStore, save_blocks

__all__ = ["BlockStore", "save_blocks"]

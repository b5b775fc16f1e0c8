"""Sharded paths of the port: ranks over torch.distributed, the mesh layout,\nand the edge-sharded solver."""

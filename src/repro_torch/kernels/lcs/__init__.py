from repro_torch.kernels.lcs.lcs import lcs_table_kernel, lcs_tile_kernel
from repro_torch.kernels.lcs.ops import lcs_wavefront
from repro_torch.kernels.lcs.ref import lcs_tile_ref, lcs_tiles_ref

__all__ = ["lcs_table_kernel", "lcs_tile_kernel", "lcs_wavefront",
           "lcs_tile_ref", "lcs_tiles_ref"]

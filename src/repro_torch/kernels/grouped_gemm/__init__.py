from .ops import grouped_gemm, grouped_gemm_parts, tile_table

__all__ = ["grouped_gemm", "grouped_gemm_parts", "tile_table"]

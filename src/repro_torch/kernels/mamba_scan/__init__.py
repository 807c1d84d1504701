from .ops import mamba_scan_stage

__all__ = ["mamba_scan_stage"]

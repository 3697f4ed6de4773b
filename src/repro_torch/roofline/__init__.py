from .analysis import HW, collective_bytes, roofline_terms, summarize_cell

__all__ = ["HW", "collective_bytes", "roofline_terms", "summarize_cell"]

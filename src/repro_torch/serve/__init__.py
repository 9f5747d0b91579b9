from .engine import Request, ServeEngine, scatter_cache
from .kvcache import ZERO_PAGE, PagedKVCache

__all__ = ["ServeEngine", "Request", "scatter_cache", "PagedKVCache",
           "ZERO_PAGE"]

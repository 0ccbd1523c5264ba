from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paging import BlockTables, PagePool, paco_page_size

__all__ = ["Request", "ServeEngine", "BlockTables", "PagePool",
           "paco_page_size"]

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paging import (BlockTables, PagePool, paco_draft_len,
                                      paco_page_size)
from repro_torch.serve.reference import reference_decode

__all__ = ["Request", "ServeEngine", "BlockTables", "PagePool",
           "paco_draft_len", "paco_page_size", "reference_decode"]

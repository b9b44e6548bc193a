from financial_rag_tpu_torch.store.snowflake import SnowflakeGenerator
from financial_rag_tpu_torch.store.parent_store import ParentStore
from financial_rag_tpu_torch.store.child_meta import ChildMetaStore

__all__ = ["SnowflakeGenerator", "ParentStore", "ChildMetaStore"]

"""repro_torch.core -- the paged two-tier embedding engine on one device,
and the access profiler and buffer policies (``hot_cache``)."""
from repro_torch.core.paging import (  # noqa: F401
    HOT_SHARD, PageTable, PagingConfig, initial_page_table, locate)
from repro_torch.core.pifs import (  # noqa: F401
    EngineState, PIFSEmbeddingEngine, engine_for_tables)
from repro_torch.core.planner import (  # noqa: F401
    PlannerConfig, needs_migration, plan, shard_loads)
from repro_torch.core import hot_cache, sls  # noqa: F401

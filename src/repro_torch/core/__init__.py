"""repro_torch.core -- the paged two-tier embedding engine on one device.
The reference's ``hot_cache`` module comes with the simulator
(``ROADMAP.md`` queue 1 item 16)."""
from repro_torch.core.paging import (  # noqa: F401
    HOT_SHARD, PageTable, PagingConfig, initial_page_table, locate)
from repro_torch.core.pifs import (  # noqa: F401
    EngineState, PIFSEmbeddingEngine, engine_for_tables)
from repro_torch.core.planner import (  # noqa: F401
    PlannerConfig, needs_migration, plan, shard_loads)
from repro_torch.core import sls  # noqa: F401

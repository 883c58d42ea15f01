from repro_torch.serving.engine import (ContinuousBatchingEngine, EngineConfig,
                                        EngineStats)
from repro_torch.serving.kv_cache import BlockManager, OutOfBlocksError

__all__ = ["ContinuousBatchingEngine", "EngineConfig", "EngineStats",
           "BlockManager", "OutOfBlocksError"]

from repro_torch.serving.cluster import ThreadedCluster
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig, EngineStats
from repro_torch.serving.faults import (EngineCrashed, EngineDead, EngineFailure,
                                  FaultPlan, FaultSpec, FaultyEngine,
                                  TransientEngineError)
from repro_torch.serving.frontend import (AsyncServer, FrontendConfig,
                                    FrontendStats, RequestStream, run_session)
from repro_torch.serving.kv_cache import BlockManager, OutOfBlocksError

__all__ = ["ContinuousBatchingEngine", "EngineConfig", "EngineStats",
           "BlockManager", "OutOfBlocksError",
           "AsyncServer", "FrontendConfig", "FrontendStats", "RequestStream",
           "run_session", "ThreadedCluster",
           "EngineFailure", "EngineCrashed", "EngineDead",
           "TransientEngineError", "FaultSpec", "FaultPlan", "FaultyEngine"]

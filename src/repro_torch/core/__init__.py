from repro_torch.core.request import (
    SLO_BATCH1,
    SLO_BATCH2,
    SLO_CLASSES,
    SLO_INTERACTIVE,
    Request,
    make_request,
)

__all__ = ["Request", "make_request", "SLO_CLASSES", "SLO_INTERACTIVE",
           "SLO_BATCH1", "SLO_BATCH2"]

"""Online serving: the BCNN slot engine and its replica fleet (router,
replicas, autoscaler), and the LM engine (``serve/engine.py``)."""
from repro_torch.serve.bcnn_engine import (BCNNEngine,  # noqa: F401
                                          drive_poisson)
from repro_torch.serve.slots import (Request, SlotScheduler,  # noqa: F401
                                     latency_stats)
from repro_torch.serve.replica import EngineReplica, SwapTicket  # noqa: F401
from repro_torch.serve.autoscale import (AutoscaleConfig,  # noqa: F401
                                         FleetAutoscaler, ScaleEvent)
from repro_torch.serve.router import (BULK, DEFAULT_CLASSES,  # noqa: F401
                                      ONLINE, RequestClass, Router,
                                      RouterOverload, RouterRequest,
                                      RouterShutdown, drive_mixed_poisson)

"""Serving front-ends (port of ``repro/serving``): the synchronous
``PredictorEngine``, the fault-tolerant ``SimulationService`` and the
chaos layer's ``FaultInjector``."""
from repro_torch.serving.engine import (PredictorEngine,  # noqa: F401
                                        Request, Result, validate_request)
from repro_torch.serving.faults import (FaultInjected,  # noqa: F401
                                        FaultInjector)
from repro_torch.serving.service import (ServiceResult,  # noqa: F401
                                         ServiceSLA, ServiceTicket,
                                         SimulationService, build_ladder)

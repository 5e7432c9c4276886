from repro_torch.serving.engine import (AuditError, Request,  # noqa: F401
                                        RequestStatus, ServingEngine,
                                        StepOutcome)
from repro_torch.serving.faultinject import (FaultInjector,  # noqa: F401
                                             InjectedFault)

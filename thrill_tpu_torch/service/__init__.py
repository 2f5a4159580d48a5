"""The service plane (counterpart of the reference package's
``service/``): one long-lived Context serving many pipelines from many
clients.

* :mod:`.scheduler`: ``ctx.submit(pipeline_fn, tenant=...) ->
  JobFuture``, concurrent submission from client threads, serialized
  onto the mesh in weighted-fair order across tenants, each job in its
  own failure domain;
* :mod:`.tenancy`: per-tenant HBM budgets on the governor's tenant
  ledger (mem/hbm.py);
* :mod:`.plan_store`: learned plan state across restarts;
* :mod:`.front_door` and :mod:`.client`: the network edge, with typed
  shed-load rejects, chunked result streams, deadlines and drain;
* :mod:`.autoscale`: the policy that decides when the mesh resizes.
"""

from .scheduler import (JobFuture, QueueFull, RateLimited,  # noqa: F401
                        Scheduler, ShedLoad, TenantQueueFull)
from .tenancy import activate, configure, set_budget  # noqa: F401
from .plan_store import PlanStore  # noqa: F401
from .front_door import FrontDoor  # noqa: F401
from .client import (FrontDoorClient, Rejected,  # noqa: F401
                     RemoteJob, RemoteJobError)

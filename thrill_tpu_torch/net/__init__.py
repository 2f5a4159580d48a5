"""The host network layer of a mesh of several processes (counterpart
of the reference package's ``net/``): the group and its collectives
(``group``), the wire codec (``wire``), the in-process mock network
(``mock``), the TCP backend (``tcp``) with its asynchronous engine
(``dispatcher``) and liveness heartbeats (``heartbeat``), the MPI
backend (``mpi``) and the flow-control channel (``flow``)."""

from .group import Group, Connection  # noqa: F401
from .mock import MockNetwork  # noqa: F401
from .flow import FlowControlChannel, LocalFlowControl  # noqa: F401

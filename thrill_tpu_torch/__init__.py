"""thrill_tpu_torch: the PyTorch/CUDA port of thrill_tpu.

Lazy DIA pipelines over W virtual workers held as the leading tensor
dimension on one device per process (``RunDistributed`` spreads the
workers over several processes). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``. The port imports neither jax nor
thrill_tpu.
"""

from .api import (Bind, Concat, Context, DIA, FieldReduce, InnerJoin, Iterate,
                  Merge, Run, RunDistributed, RunLocalMock, RunLocalTests,
                  RunSupervised, Union, Zip, ZipWindow)
from .parallel.mesh import MeshExec

__all__ = ["Bind", "Concat", "Context", "DIA", "FieldReduce", "InnerJoin",
           "Iterate", "Merge", "MeshExec", "Run", "RunDistributed",
           "RunLocalMock", "RunLocalTests", "RunSupervised", "Union",
           "Zip", "ZipWindow"]

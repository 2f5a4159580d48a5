"""thrill_tpu_torch: the PyTorch/CUDA port of thrill_tpu.

Lazy DIA pipelines over W virtual workers held as the leading tensor
dimension on one device. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The port imports neither jax nor thrill_tpu.
"""

from .api import (Bind, Context, DIA, FieldReduce, InnerJoin, Iterate, Run,
                  RunLocalTests, Zip)
from .parallel.mesh import MeshExec

__all__ = ["Bind", "Context", "DIA", "FieldReduce", "InnerJoin", "Iterate",
           "MeshExec", "Run", "RunLocalTests", "Zip"]

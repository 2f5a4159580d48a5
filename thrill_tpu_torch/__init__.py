"""thrill_tpu_torch: the PyTorch/CUDA port of thrill_tpu.

Lazy DIA pipelines over W virtual workers held as the leading tensor
dimension on one device. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The port imports neither jax nor thrill_tpu.
"""

from .api.context import Context, Run, RunLocalTests
from .api.functors import FieldReduce
from .parallel.mesh import MeshExec

__all__ = ["Context", "FieldReduce", "MeshExec", "Run", "RunLocalTests"]

from .context import Context, Run, RunLocalTests  # noqa: F401
from .dia import DIA, InnerJoin, Zip  # noqa: F401
from .functors import FieldReduce  # noqa: F401
from .loop import Iterate  # noqa: F401
from .stack import Bind  # noqa: F401

from .context import (Context, Run, RunDistributed, RunLocalMock,  # noqa: F401
                      RunLocalTests, RunSupervised)
from .dia import (DIA, Concat, InnerJoin, Merge, Union, Zip,  # noqa: F401
                  ZipWindow)
from .functors import FieldReduce  # noqa: F401
from .loop import Iterate  # noqa: F401
from .stack import Bind  # noqa: F401

"""Device-side execution helpers shared by operator implementations
(counterpart of the reference package's ``api/device_exec.py``).

The port keeps ``apply_stack_device``, an LOp stack applied to device
shards as one program, beside the other stack helpers in
``api/stack.py``; this module re-exports it under the reference's
module name.
"""

from .stack import apply_stack_device  # noqa: F401

"""The service plane (counterpart of the reference package's
``service/``): the plan store so far."""

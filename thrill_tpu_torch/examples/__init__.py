"""The port's copies of the reference's example pipelines."""

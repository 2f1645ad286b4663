from .fibonacci import FibonacciAir  # noqa: F401

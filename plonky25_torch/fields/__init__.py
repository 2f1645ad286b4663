from . import goldilocks as gl  # noqa: F401
from . import extension as gl2  # noqa: F401
from . import extension3 as gl3  # noqa: F401
from .goldilocks import GL  # noqa: F401
from .extension import GL2  # noqa: F401

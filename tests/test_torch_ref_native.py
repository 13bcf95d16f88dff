"""``tests/test_native.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_native", globals())  # noqa: E702

"""``tests/test_minimal.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_minimal", globals())  # noqa: E702

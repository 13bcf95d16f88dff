"""``tests/test_large.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_large", globals())  # noqa: E702

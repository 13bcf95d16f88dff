"""``tests/test_all.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_all", globals())  # noqa: E702

"""``tests/test_server.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_server", globals())  # noqa: E702

"""``tests/test_cli.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_cli", globals())  # noqa: E702

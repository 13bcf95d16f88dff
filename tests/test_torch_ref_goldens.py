"""``tests/test_goldens.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_goldens", globals())  # noqa: E702

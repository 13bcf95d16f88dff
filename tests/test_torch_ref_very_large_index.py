"""``tests/test_very_large_index.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_very_large_index", globals())  # noqa: E702

"""``tests/test_gutenberg.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_gutenberg", globals())  # noqa: E702

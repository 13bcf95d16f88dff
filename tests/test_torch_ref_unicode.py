"""``tests/test_unicode.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_unicode", globals())  # noqa: E702

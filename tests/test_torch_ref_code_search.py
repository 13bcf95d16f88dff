"""``tests/test_code_search.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_code_search", globals())  # noqa: E702

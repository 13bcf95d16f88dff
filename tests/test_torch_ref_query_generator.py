"""``tests/test_query_generator.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_query_generator", globals())  # noqa: E702

"""``tests/test_query_parser.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_query_parser", globals())  # noqa: E702

"""``tests/test_facet.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_facet", globals())  # noqa: E702

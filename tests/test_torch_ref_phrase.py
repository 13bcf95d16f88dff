"""``tests/test_phrase.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_phrase", globals())  # noqa: E702

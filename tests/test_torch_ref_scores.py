"""``tests/test_scores.py`` run on the port (``tests/torch_rebind.py``)."""
from torch_rebind import rebind; rebind("test_scores", globals())  # noqa: E702

"""The 37-symbol character set (reference ``data_utils.py:243-258``); the
CTC blank is the index after the last symbol."""

import string

CHARS = string.ascii_lowercase + string.digits + " "

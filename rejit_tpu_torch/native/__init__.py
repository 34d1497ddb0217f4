"""Native (C++) host helpers: greedy selection, replacement splices, scalar
DFA runs and line lookups (select.cc), compiled with g++ at first use
(build.py) and loaded with ctypes (lib.py). Every caller keeps a Python
path; `Config(selection='python')` takes it and never builds the library.

Build ahead of use with:  python -m rejit_tpu_torch.native.build
"""

"""The port's host-compiled C++: the C ABI (``pumiumtally_c.h`` /
``pumiumtally_c.cpp``, an embedded interpreter hosting ``api.native``),
the C++ facade ``PumiumTally.hpp``, three host programs, and
``build.py``, which compiles them into ``_build/``; and the staging fill
``host_fill.cpp``, built and called by ``host_fill.py``."""

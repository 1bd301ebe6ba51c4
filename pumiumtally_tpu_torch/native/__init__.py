"""The port's C ABI: ``pumiumtally_c.h`` / ``pumiumtally_c.cpp`` (an
embedded interpreter hosting ``api.native``), the C++ facade
``PumiumTally.hpp``, three host programs, and ``build.py``, which
compiles them into ``_build/``."""

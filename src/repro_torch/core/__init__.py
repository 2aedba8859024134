"""Core: the paper's contribution — state-space synthesis of networks; the
port's counterpart of ``repro/core``.

``state_space`` (the execution form), ``cslow`` (C-slow retiming),
``transition`` (j-step composition and the diagonal linear recurrences),
``quantization`` (numpy fixed-point analysis) and ``synthesis`` (``NetworkSpec``, the Table-I constructors and
``synthesize``).  Submodules are imported by name; this package imports
nothing eagerly, so that ``codegen`` and ``synthesis`` can import each other's
pieces without a cycle.
"""

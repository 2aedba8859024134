"""Weight-only int8 helpers: ``ops.quantize_per_channel``.  The
``int8_matmul`` kernel itself is not ported yet (ROADMAP, Queue 2)."""

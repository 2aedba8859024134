"""ROM-LUT tanh: the table constructor ``ref.make_lut``."""

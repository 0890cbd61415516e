"""PSA data generators and partitioners (NumPy RNG, as the reference), and
the LM token stream."""

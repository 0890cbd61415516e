"""The LM serving stack: layers, GQA attention and the decoder."""

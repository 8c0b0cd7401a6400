"""Models of the port: the decoders, the CLIP vision embedder and the text
classifier."""

"""Models: the transformer LM, cached decoding, the LM serving entries and
the weight converter from nnstreamer_tpu's parameter pytrees."""

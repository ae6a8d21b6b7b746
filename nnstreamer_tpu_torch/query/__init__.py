"""Tensor query (L5): the NNSQ protocol, the query client and server, the
edge pub/sub, MQTT (standard library only) with hybrid discovery, and the
gRPC bridge — the counterpart of nnstreamer_tpu's ``query`` package. Every
element runs on the host; a filter behind a query server runs where its
``accelerator`` puts it."""

"""Pipeline elements: sources, sinks and the tensor_filter."""

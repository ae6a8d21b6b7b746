"""Runtime: pads, elements, the pipeline and the launch-line parser."""

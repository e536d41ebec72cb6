"""Host-side file formats and the sequence chunker (copies of the parts of
jellyfish_tpu/io that `count` uses)."""

"""Service tokens of the coding table (from ``isp_tts_tpu/data/text/symbols.py``)."""

PAD = "<pad>"
EOS = "</s>"

"""Peer table and health machine (counterpart of
``crowdllama_tpu/peermanager``)."""

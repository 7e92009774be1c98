"""Control-plane networking: the stream host, the Kademlia-style DHT and
discovery (counterpart of ``crowdllama_tpu/net``, direct TCP only)."""

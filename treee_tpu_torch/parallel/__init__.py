"""Surveys beyond one card: halo tiles (``tiles``) and point-sharded steps
over a list of devices (``sharding``)."""

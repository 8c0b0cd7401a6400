"""The worker-side restore stage of the port (counterpart of
``tpu9/worker``): the double-buffered shard stream and its consumer for the
card. The worker itself is control plane and stays the reference's. Import
the modules themselves."""

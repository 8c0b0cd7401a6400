"""The runner-side hooks of the port (counterpart of ``tpu9/runner``): a
torch handler's checkpoint save and restore. The runner itself stays the
reference's. Import the modules themselves."""

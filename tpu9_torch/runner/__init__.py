"""The runner-side hooks of the port (counterpart of ``tpu9/runner``): a
torch handler's checkpoint save and restore (``ckpt``) and the
pre-warmed fork-server that starts torch containers (``zygote``). The
runner itself stays the reference's. Import the modules themselves."""

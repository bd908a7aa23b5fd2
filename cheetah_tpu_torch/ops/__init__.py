"""Transfer maps and the cloud-in-cell kernels."""

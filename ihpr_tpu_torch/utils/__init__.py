"""Host-side utilities: the output tree, graceful SIGTERM, the host-RSS
watchdog's helpers."""

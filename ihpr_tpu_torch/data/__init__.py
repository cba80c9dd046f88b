"""Host-side data helpers and the device-side patch finalization."""

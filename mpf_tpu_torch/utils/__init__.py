"""Host utilities (numpy only, plus the device oracle)."""

"""Host-side analysis helpers of the port (numpy only)."""

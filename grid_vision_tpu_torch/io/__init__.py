"""Host-side I/O helpers of the torch port."""

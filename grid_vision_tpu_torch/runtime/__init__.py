"""Drive helpers of the torch port."""

"""Weight import/export helpers of the port."""

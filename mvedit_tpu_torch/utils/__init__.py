"""Host-side camera math and depth utilities of the port."""

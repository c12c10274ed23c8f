"""Sharding of the port: the logical-axis rules (`rules`), the activation
constraints the models call (`ctx`); the meshes are in `launch.mesh`."""

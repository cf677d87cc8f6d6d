"""The multi-device layer (port of agi_lidar_slam_tpu/parallel/).

distributed.py  process-group bring-up, the DeviceMesh, the collectives
sharding.py     the point-sharded ("dp") engine steps and the mesh helpers
map_shard.py    the slot-sharded ("mp") map: merged KNN, insert, bound
launch.py       spawns a group of ranks on one machine, with a deadline
"""

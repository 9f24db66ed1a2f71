"""Small sizes at which the benchmark's cells run on the CPU in tests:
every width of the configurations kept where the CPU allows, the images,
the sample budget, the keypoints and LightGlue's depth cut."""

SEED = 2**31 + 77          # a seed beyond 32 signed bits

TRAFFIC = {"canvas": 96, "content": [[72, 96], [96, 72]], "pool": 4,
           "check_from": 1, "check_calls": 1}
DKM = {"config": {"gim_config": {"dkm": {
    "h_resized": 64, "w_resized": 96, "upsample_res": [96, 128],
    "num_samples": 200}},
    # the CPU runs K2's plain version, which the launch counter skips
    "launches_per_pair": {"refiner_block": 0}},
    "traffic": TRAFFIC}
LIGHTGLUE = {"config": {"gim_config": {
    "superpoint": {"max_num_keypoints": 256}, "lightglue": {"n_layers": 2}}},
    "traffic": TRAFFIC}
OVERRIDES = {
    "dkm-match": DKM, "dkm-zeb": DKM, "lightglue-match": LIGHTGLUE,
    "lightglue-zeb": {**LIGHTGLUE, "traffic": {**TRAFFIC, "batch": 2}},
}

"""scene_load_s: the program's scene load in set-up (glTF and KTX parse,
PNG decode, texture heap, scene_to_torch), host clock."""


def read(run):
    return run.scene_load_s

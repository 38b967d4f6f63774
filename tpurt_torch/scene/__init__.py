from tpurt_torch.scene.api import PbrtAPI, load_scene, load_scene_string
from tpurt_torch.scene.paramset import ParamSet, TextureParams
from tpurt_torch.scene.records import SceneDescription
